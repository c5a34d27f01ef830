"""linevis_tpu_torch sort-carried tile binning vs the JAX package on the CPU.

Bars: tile_start and tile_count exactly equal; each tile's run holds the
same pairs (compared as multisets of payload columns, because the JAX sort
is unstable within one key: linevis_tpu/kernels/raster_pallas.py:187-195);
the payload columns carried through the sort are bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels.raster_pallas import build_sorted_binning as jbin
from linevis_tpu.kernels.tiles import unpack_tiles as junpack
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.kernels.raster_pallas import build_sorted_binning as tbin
from linevis_tpu_torch.kernels.tiles import unpack_tiles as tunpack
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.pipeline import RasterSettings

torch.set_num_threads(1)


def _runs_equal(jp, js, jc, tp, ts, tc):
    """Same start/count per tile; same multiset of columns in each run."""
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)
    assert tp.shape == jp.shape
    for s, c in zip(ts, tc):
        a = jp[:, s:s + c]
        b = tp[:, s:s + c]
        # Order each run by (id row 9, then every row) and compare exactly.
        oa = np.lexsort(a[::-1])
        ob = np.lexsort(b[::-1])
        np.testing.assert_array_equal(a[:, oa], b[:, ob])


def _random_prims(seed, T, width, height):
    rng = np.random.default_rng(seed)
    sxa = rng.uniform(-20, width + 20, T).astype(np.float32)
    sya = rng.uniform(-20, height + 20, T).astype(np.float32)
    sxb = (sxa + rng.normal(0, 12, T)).astype(np.float32)
    syb = (sya + rng.normal(0, 12, T)).astype(np.float32)
    sr = rng.uniform(0.2, 6.0, T).astype(np.float32)
    xmin = np.minimum(sxa, sxb) - sr
    xmax = np.maximum(sxa, sxb) + sr
    ymin = np.minimum(sya, syb) - sr
    ymax = np.maximum(sya, syb) + sr
    rows = rng.normal(size=(16, T)).astype(np.float32)
    rows[9] = np.arange(T, dtype=np.float32)
    # Bucket-floored depths with many shared keys (exercises the tie order).
    rows[15] = np.floor(rng.uniform(0, 1, T) * 40) / 1023.0
    valid = rng.uniform(size=T) > 0.1
    return (xmin, xmax, ymin, ymax, rows, valid), (sxa, sya, sxb, syb, sr)


@pytest.mark.parametrize(
    "span,tile,use_seg2d",
    [((2, 2), (16, 8), True), ((3, 3), (16, 8), False), ((2, 3), (32, 16), True)],
)
def test_build_sorted_binning_matches_jax(span, tile, use_seg2d):
    W, H, T = 150, 70, 600
    args, seg2d = _random_prims(7, T, W, H)
    kw = dict(tile_w=tile[0], tile_h=tile[1], chunk=16, span_x=span[0], span_y=span[1])
    j = jbin(*map(jnp.asarray, args), W, H,
             seg2d=tuple(map(jnp.asarray, seg2d)) if use_seg2d else None, **kw)
    t = tbin(*map(torch.tensor, args), W, H,
             seg2d=tuple(map(torch.tensor, seg2d)) if use_seg2d else None, **kw)
    assert (t.tiles_x, t.tiles_y, t.chunk) == (j.tiles_x, j.tiles_y, j.chunk)
    assert t.tile_start.dtype == torch.int32 and t.tile_count.dtype == torch.int32
    tp = t.payload.numpy()
    _runs_equal(np.asarray(j.payload), np.asarray(j.tile_start),
                np.asarray(j.tile_count), tp, t.tile_start.numpy(),
                t.tile_count.numpy())
    assert int(t.tile_count.sum()) > T // 2
    assert (tp[:, -16:] == 0).all()  # the chunk padding columns


def test_prepare_capsule_frame_matches_jax():
    """Projection, payload rows 0-23, binning and params on the golden walk
    scene, with the coverage-AA cull margin."""
    rng = np.random.default_rng(11)
    pos = np.cumsum(rng.normal(0, 0.07, (10, 8, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    mask = np.ones((10, 8), bool)
    mask[3, 6:] = False
    attrs = rng.uniform(0, 1, (10, 8)).astype(np.float32)
    W, H = 160, 120
    cam = JCamera(position=(0.0, 0.1, 1.2), width=W, height=H)
    vp = cam.view_projection_matrix()
    cp = np.asarray(cam.position, np.float32)
    ab = jtr._proj_constants(cam)
    kw = dict(width=W, height=H, tile_w=16, tile_h=8, chunk=32, span_x=3, span_y=3)
    jcsr, jparams, jbasis = jtr.prepare_capsule_frame(
        jtr.build_capsule_scene(pos, mask, attrs, 0.02), jnp.asarray(vp),
        jnp.asarray(cp), jnp.asarray(ab), JSettings(**kw), aa_margin=0.5,
    )
    tcsr, tparams, tbasis = ttr.prepare_capsule_frame(
        ttr.build_capsule_scene(pos, mask, attrs, 0.02, device="cpu"),
        torch.tensor(vp), torch.tensor(cp), torch.tensor(ab),
        RasterSettings(**kw), aa_margin=0.5,
    )
    js, jc = np.asarray(jcsr.tile_start), np.asarray(jcsr.tile_count)
    ts, tc = tcsr.tile_start.numpy(), tcsr.tile_count.numpy()
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)
    jp, tp = np.asarray(jcsr.payload), tcsr.payload.numpy()
    assert tp.shape == jp.shape == (24, jp.shape[1])
    # Same pairs per run (by id); rows agree to float32 rounding of the
    # projection and dot products (XLA contracts into FMAs).
    for s, c in zip(ts, tc):
        a, b = jp[:, s:s + c], tp[:, s:s + c]
        a = a[:, np.argsort(a[9], kind="stable")]
        b = b[:, np.argsort(b[9], kind="stable")]
        np.testing.assert_array_equal(a[9], b[9])
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(tparams.numpy(), np.asarray(jparams), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(tbasis.numpy(), np.asarray(jbasis), rtol=1e-6, atol=1e-8)
    assert tc.sum() > 100


def test_unpack_tiles_matches_jax():
    rng = np.random.default_rng(3)
    tiled = rng.normal(size=(5 * 4, 16 * 8)).astype(np.float32)
    j = junpack(jnp.asarray(tiled), 5, 4, 16, 8, 75, 30)
    t = tunpack(torch.tensor(tiled), 5, 4, 16, 8, 75, 30)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
