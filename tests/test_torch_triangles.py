"""linevis_tpu_torch triangle tube frame vs the JAX package on the CPU.

The same numpy inputs go through the JAX function (Pallas kernel in
interpret mode) and its port (plain PyTorch version on CPU tensors). Bars:
- `build_csr_binning`: `tile_chunk_base`, `tile_num_chunks`, `overflow` and
  the payload (so the slot order) identical: both sorts are stable;
- the triangle raster on the same CSR arrays: ids equal on >= 99.9% of
  pixels (measured on these scenes: all; a pixel centre within one float32
  ulp of an edge may fall on either side, ROADMAP queue C), background
  exact, depth and every attribute plane within 2 ulp (2^-22) of the plane's
  term magnitude |a| gx + |b| gy + |c| where the ids agree (measured: 1.25
  ulp). A plane value ~1 is the sum of terms that reach ~3e3 at 320x240, so
  it carries that sum's round-off, and the two packages round it in
  different orders: the port evaluates (a*gx + b*gy) + c unfused, XLA:CPU
  contracts the K=3 product to fused multiply-adds;
- `tube_vertex_stage`, `build_payload`, `shade_gbuffer`: 1e-5 relative to
  each row's largest magnitude (payload rows reach 1e6);
- whole images at SSIM >= 0.999 and mean abs <= 2e-3 against the JAX
  package run as it is, and the checked-in golden at the golden harness's
  bar (SSIM >= 0.99, mean difference <= 2e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.geometry import tubes as jtubes
from linevis_tpu.kernels import raster_pallas as jrp
from linevis_tpu.render import opaque as jop
from linevis_tpu.render import pipeline as jpl
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.transfer_function import TransferFunction as JTF
from linevis_tpu_torch.convert import tube_mesh_from_numpy
from linevis_tpu_torch.entry import entry_triangle
from linevis_tpu_torch.geometry import tubes as ttubes
from linevis_tpu_torch.kernels import raster_pallas as trp
from linevis_tpu_torch.render import opaque as top
from linevis_tpu_torch.render import pipeline as tpl
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.transfer_function import TransferFunction

from tests.test_torch_geometry import _golden_walk

torch.set_num_threads(1)

GOLDEN = __file__.replace("test_torch_triangles.py", "golden/triangle_tubes.png")
ULP2 = 2.0 ** -22


def _soup_batch(T=60, W=64, H=32, seed=0):
    """A numpy-seeded triangle soup with random corner attributes."""
    rng = np.random.default_rng(seed)

    def f(lo, hi, shape):
        return torch.tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    xy = f(-8, W + 8, (2, 1, T)) + f(-20, 20, (2, 3, T))
    return tpl.TriangleBatch(
        tri_x=xy[0], tri_y=xy[1] * H / W, tri_z=f(0.05, 0.95, (3, T)),
        tri_valid=torch.tensor(rng.uniform(size=T) > 0.1),
        corner_inv_w=f(0.5, 1.5, (3, T)), corner_attr=f(0, 1, (3, T)),
        corner_normal=tuple(f(-1, 1, (3, T)) for _ in range(3)),
        corner_tangent=tuple(f(-1, 1, (3, T)) for _ in range(3)),
        view_z_min=torch.tensor(0.0), view_z_max=torch.tensor(1.0),
    )


def _golden_mesh(device="cpu"):
    pos, mask, attrs = _golden_walk()
    return ttubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02, device=device)


def _tube_batch(W, H):
    cam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=W, height=H)
    return tpl.tube_vertex_stage(
        _golden_mesh(), torch.tensor(cam.view_projection_matrix()), W, H
    )


# name -> (batch, W, H, tile_w, tile_h, chunk, span)
CASES = {
    "soup_chunk16": (lambda: _soup_batch(), 64, 32, 16, 8, 16, 4),
    "soup_dense_chunk16": (lambda: _soup_batch(T=300, seed=2), 64, 32, 16, 8, 16, 4),
    "tube_chunk128": (lambda: _tube_batch(160, 120), 160, 120, 16, 8, 128, 3),
    "tube_chunk16_tile32": (lambda: _tube_batch(160, 120), 160, 120, 32, 16, 16, 2),
}


def _binnings(name, pairs_capacity=0):
    make, W, H, tw, th, chunk, span = CASES[name]
    batch = make()
    payload = tpl.build_payload(batch)
    t = trp.build_csr_binning(batch.tri_x, batch.tri_y, payload, batch.tri_valid,
                              W, H, tw, th, chunk, span, span, pairs_capacity)
    j = jrp.build_csr_binning(
        jnp.asarray(batch.tri_x.numpy()), jnp.asarray(batch.tri_y.numpy()),
        jnp.asarray(payload.numpy()), jnp.asarray(batch.tri_valid.numpy()),
        W, H, tw, th, chunk, span, span, pairs_capacity,
    )
    return t, j, (tw, th)


def _to_jax(csr):
    return jrp.CsrBinning(
        jnp.asarray(csr.payload.numpy()), jnp.asarray(csr.tile_chunk_base.numpy()),
        jnp.asarray(csr.tile_num_chunks.numpy()), jnp.asarray(csr.overflow.numpy()),
        csr.tiles_x, csr.tiles_y, csr.chunk,
    )


@pytest.mark.parametrize(
    "name,pairs_capacity", [*((n, 0) for n in sorted(CASES)), ("soup_dense_chunk16", 40)]
)
def test_build_csr_binning_matches_jax(name, pairs_capacity):
    t, j, _ = _binnings(name, pairs_capacity)
    assert (t.tiles_x, t.tiles_y, t.chunk) == (j.tiles_x, j.tiles_y, j.chunk)
    for f in ("tile_chunk_base", "tile_num_chunks", "overflow", "payload"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.numpy().dtype == b.dtype and tuple(a.shape) == b.shape, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert int(t.tile_num_chunks.sum()) > 0
    assert (int(t.overflow) > 0) == (pairs_capacity > 0)


def _term_magnitude(csr, tile, num_planes):
    """|a| gx + |b| gy + |c| of the winner's depth and attribute planes:
    the raster of the same CSR with those rows' absolute values."""
    p = csr.payload.clone()
    p[16:] = p[16:].abs()
    mags = trp.rasterize_gbuffer(dataclasses.replace(csr, payload=p), num_planes, *tile)[2]
    p = csr.payload.clone()
    p[16:19] = csr.payload[9:12].abs()
    zmag = trp.rasterize_gbuffer(dataclasses.replace(csr, payload=p), 1, *tile)[2][0]
    return zmag.numpy(), [m.numpy() for m in mags]


def _early_z_work(csr, tile_w, tile_h):
    """The chunks each tile evaluates with the early-z exit, counted in
    numpy from the payload alone: the tile's depth after chunk c is the
    running minimum of 2.0 and each chunk's nearest covering depth per
    pixel, and the tile stops at the first chunk c > 0 whose row 15 (slot
    0) lies behind every pixel of the depth after chunk c - 1."""
    p = csr.payload.numpy()
    base, nch = csr.tile_chunk_base.numpy(), csr.tile_num_chunks.numpy()
    lin = np.arange(tile_w * tile_h)
    out = np.zeros_like(nch)
    for t in np.flatnonzero(nch):
        coef = p[:, base[t]:base[t] + nch[t], :, None]  # [R, n, C, 1]
        gx = ((t % csr.tiles_x) * tile_w + lin % tile_w).astype(np.float32) + np.float32(0.5)
        gy = ((t // csr.tiles_x) * tile_h + lin // tile_w).astype(np.float32) + np.float32(0.5)

        def plane(r):
            return (coef[r] * gx + coef[r + 1] * gy) + coef[r + 2]

        z = plane(9)
        inside = (plane(0) >= 0) & (plane(3) >= 0) & (plane(6) >= 0) & (z >= 0) & (z <= 1)
        nearest = np.where(inside, z, np.float32(np.inf)).min(axis=1)  # [n, P]
        depth = np.minimum.accumulate(np.minimum(nearest, np.float32(2.0)), axis=0)
        behind = coef[15, 1:, 0, 0] > depth[:-1].max(axis=1)
        out[t] = 1 + np.argmax(behind) if behind.any() else nch[t]
    return out


@pytest.mark.parametrize("early_z", [True, False], ids=["early_z", "no_early_z"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_triangle_reference_matches_pallas(name, early_z):
    t, _, tile = _binnings(name)
    j = _to_jax(t)  # the same CSR arrays on both sides
    jz, jid, jg = jrp.rasterize_gbuffer_pallas(j, 8, *tile, interpret=True,
                                               use_early_z=early_z)
    launches = trp.rasterize_gbuffer.launches
    work = torch.zeros(t.tile_chunk_base.shape[0], dtype=torch.int32)
    tz, tid, tg = trp.rasterize_gbuffer(t, 8, *tile, use_early_z=early_z, work=work)
    assert trp.rasterize_gbuffer.launches == launches  # CPU: plain version
    # Chunks evaluated: all without early-z; with it, as counted in numpy.
    want = torch.from_numpy(_early_z_work(t, *tile)) if early_z else t.tile_num_chunks
    assert torch.equal(work, want)
    jz, jid, tz, tid = np.asarray(jz), np.asarray(jid), tz.numpy(), tid.numpy()

    assert tid.dtype == np.int32 and tid.shape == jid.shape and len(tg) == 8
    agree = jid == tid
    assert agree.mean() >= 0.999
    hit = agree & (tid >= 0)
    assert hit.sum() > 0.03 * hit.size
    miss = agree & (tid < 0)
    assert (tz[miss] == 2.0).all() and (jz[miss] == 2.0).all()
    zmag, mags = _term_magnitude(t, tile, 8)
    assert (np.abs(jz - tz)[hit] <= ULP2 * zmag[hit]).all()
    for a, b, m in zip(jg, tg, mags):
        a, b = np.asarray(a), b.numpy()
        assert (a[miss] == 0).all() and (b[miss] == 0).all()
        assert (np.abs(a - b)[hit] <= ULP2 * m[hit]).all()

    # Depth-only mode is the same raster without planes.
    dz, did = trp.rasterize_depth(t, *tile, use_early_z=early_z)
    assert torch.equal(dz, torch.as_tensor(tz)) and torch.equal(did, torch.as_tensor(tid))


def test_triangle_depth_only_payload_matches_pallas():
    """R = 16 (depth-only) payload through `rasterize_depth` on both sides."""
    make, W, H, tw, th, chunk, span = CASES["soup_chunk16"]
    batch = make()
    payload = tpl.build_payload(batch)[:16]
    t = trp.build_csr_binning(batch.tri_x, batch.tri_y, payload, batch.tri_valid,
                              W, H, tw, th, chunk, span, span)
    assert t.payload.shape[0] == 16
    jz, jid = jrp.rasterize_depth_pallas(_to_jax(t), tw, th, interpret=True)
    tz, tid = trp.rasterize_depth(t, tw, th)
    agree = np.asarray(jid) == tid.numpy()
    assert agree.mean() >= 0.999 and (tid >= 0).sum() > 100
    assert np.abs(np.asarray(jz) - tz.numpy())[agree].max() <= 4e-6


def test_triangle_empty_scene():
    # tests/test_raster_pallas.py:test_pallas_empty_scene on the port.
    batch = _soup_batch(T=4)
    batch = dataclasses.replace(batch, tri_valid=torch.zeros(4, dtype=torch.bool))
    t = trp.build_csr_binning(batch.tri_x, batch.tri_y, tpl.build_payload(batch),
                              batch.tri_valid, 64, 32, 16, 8, 16, 4, 4)
    assert int(t.tile_num_chunks.sum()) == 0 and int(t.overflow) == 0
    z, ids, planes = trp.rasterize_gbuffer(t, 8, 16, 8)
    assert (ids == -1).all() and (z == 2.0).all()
    assert all((p == 0).all() for p in planes)


def _flat_triangle(tri_id, z_plane):
    """Payload column of a triangle covering the whole 16x8 tile with depth
    plane `z_plane` (a, b, c)."""
    col = np.zeros(16, np.float32)
    col[[2, 5, 8]] = 1.0  # every edge functional is +1 everywhere
    col[9:12] = z_plane
    col[14] = tri_id
    col[15] = 0.0
    return col


def test_triangle_selection_rule_across_and_inside_chunks():
    """One 16x8 tile, two chunks of 16 slots, built by hand.

    Chunk 0 holds triangle 20, whose depth 0.3671875 + gx/64 is exactly 0.5
    at gx = 8.5; chunk 1 holds triangles 7 and 5 (in this slot order), flat
    at 0.5. At gx = 8.5 all three tie: the earlier chunk keeps the pixel
    (id 20, a later chunk must be strictly nearer); left of it triangle 20
    is nearer; right of it chunk 1 wins with its lowest id, 5."""
    C = 16
    reject = np.zeros(16, np.float32)
    reject[[2, 5, 8]] = -1.0
    reject[15] = 3.0
    payload = np.tile(reject[:, None, None], (1, 2, C))
    payload[:, 0, 0] = _flat_triangle(20, (1.0 / 64.0, 0.0, 0.3671875))
    payload[:, 1, 0] = _flat_triangle(7, (0.0, 0.0, 0.5))
    payload[:, 1, 1] = _flat_triangle(5, (0.0, 0.0, 0.5))
    t = trp.CsrBinning(
        payload=torch.tensor(payload), tile_chunk_base=torch.tensor([0], dtype=torch.int32),
        tile_num_chunks=torch.tensor([2], dtype=torch.int32),
        overflow=torch.tensor(0, dtype=torch.int32), tiles_x=1, tiles_y=1, chunk=C,
    )
    jz, jid = jrp.rasterize_depth_pallas(_to_jax(t), 16, 8, interpret=True,
                                         use_early_z=False)
    tz, tid = trp.rasterize_depth(t, 16, 8, use_early_z=False)
    tid2 = tid.reshape(8, 16).numpy()
    assert (tid2[:, :9] == 20).all() and (tid2[:, 9:] == 5).all()
    assert float(tz.reshape(8, 16)[0, 8]) == 0.5
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_triangle_early_z_exit_matches_pallas():
    """The early-z exit is part of the function: one 16x8 tile, chunk 0 a
    flat triangle at depth 0.5 over the whole tile, chunk 1 a triangle whose
    sort key (row 15) is 0.6 but whose depth plane is 0.3, as a float32
    plane inside a sub-pixel triangle can be. With early-z the tile stops
    before chunk 1 (0.6 lies behind its farthest pixel, 0.5) and keeps
    triangle 2; without, triangle 9 wins. The plain version matches the JAX
    kernel both ways."""
    C = 16
    reject = np.zeros(16, np.float32)
    reject[[2, 5, 8]] = -1.0
    reject[15] = 3.0
    payload = np.tile(reject[:, None, None], (1, 2, C))
    payload[:, 0, 0] = _flat_triangle(2, (0.0, 0.0, 0.5))
    payload[:, 1, 0] = _flat_triangle(9, (0.0, 0.0, 0.3))
    payload[15, 1, 0] = 0.6
    t = trp.CsrBinning(
        payload=torch.tensor(payload), tile_chunk_base=torch.tensor([0], dtype=torch.int32),
        tile_num_chunks=torch.tensor([2], dtype=torch.int32),
        overflow=torch.tensor(0, dtype=torch.int32), tiles_x=1, tiles_y=1, chunk=C,
    )
    for early_z, want in ((True, 2), (False, 9)):
        work = torch.zeros(1, dtype=torch.int32)
        tz, tid = trp.rasterize_depth(t, 16, 8, use_early_z=early_z, work=work)
        assert (tid == want).all() and int(work[0]) == (1 if early_z else 2)
        jz, jid = jrp.rasterize_depth_pallas(_to_jax(t), 16, 8, interpret=True,
                                             use_early_z=early_z)
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_triangle_reference_batches_do_not_change_result():
    t, _, tile = _binnings("tube_chunk16_tile32")
    assert int(t.tile_num_chunks.max()) > 1  # several chunks in one tile
    a = trp.rasterize_triangles_reference(t, *tile, 8, batch_elems=1)
    stats = {}
    b = trp.rasterize_triangles_reference(t, *tile, 8, stats=stats)
    assert stats["takes"] >= int((b[1] >= 0).sum())
    for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert torch.equal(x, y)


def _jax_mesh_dict(jm):
    return {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)}


def _rel_close(a, b, tol=1e-5):
    """Row-wise: |a - b| <= tol * the row's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b).reshape(b.shape[0], -1).max(axis=1), 1e-30)
    err = np.abs(a - b).reshape(b.shape[0], -1).max(axis=1)
    assert (err <= tol * scale).all(), (err / scale).max()


def test_vertex_stage_and_payload_match_jax():
    W, H = 160, 120
    pos, mask, attrs = _golden_walk()
    mask[1, 6:] = False
    jm = jtubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02)
    tm = tube_mesh_from_numpy(_jax_mesh_dict(jm), device="cpu")
    vp = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=W,
                height=H).view_projection_matrix()
    jb = jpl.tube_vertex_stage(jm, jnp.asarray(vp), W, H)
    tb = tpl.tube_vertex_stage(tm, torch.tensor(vp), W, H)
    for f in ("tri_x", "tri_y", "tri_z", "corner_inv_w", "corner_attr"):
        _rel_close(getattr(tb, f).numpy(), getattr(jb, f))
    for f in ("corner_normal", "corner_tangent"):
        for a, b in zip(getattr(tb, f), getattr(jb, f)):
            _rel_close(a.numpy(), b)
    np.testing.assert_array_equal(tb.tri_valid.numpy(), np.asarray(jb.tri_valid))
    assert 0 < int(tb.tri_valid.sum()) < tb.tri_valid.numel()
    np.testing.assert_allclose(float(tb.view_z_min), float(jb.view_z_min), rtol=1e-6)
    np.testing.assert_allclose(float(tb.view_z_max), float(jb.view_z_max), rtol=1e-6)

    # The payload from the same batch (the JAX batch as numpy on both sides).
    same = tpl.TriangleBatch(**{
        f.name: (tuple(torch.tensor(np.asarray(c)) for c in getattr(jb, f.name))
                 if isinstance(getattr(jb, f.name), tuple)
                 else torch.tensor(np.asarray(getattr(jb, f.name))))
        for f in dataclasses.fields(jb)
    })
    jp, tp = np.asarray(jpl.build_payload(jb)), tpl.build_payload(same).numpy()
    assert tp.shape == jp.shape == (40, tm.num_triangles) and tp.dtype == np.float32
    np.testing.assert_array_equal(tp[12:16], jp[12:16])  # id plane and zmin
    _rel_close(tp, jp)
    assert np.abs(jp).max() > 1e3  # the edge constants are large


def test_shade_gbuffer_matches_jax():
    rng = np.random.default_rng(5)
    H, W = 24, 40
    gbuf = {"id": rng.integers(-1, 50, (H, W)).astype(np.int32),
            "inv_w": rng.uniform(0.6, 1.0, (H, W)).astype(np.float32),
            "attr_w": rng.uniform(-0.1, 1.1, (H, W)).astype(np.float32)}
    for k in ("nx", "ny", "nz", "tx", "ty", "tz"):
        gbuf[k] = rng.normal(size=(H, W)).astype(np.float32)
    cam = JCamera(position=(0.2, 0.1, 1.3), width=W, height=H)
    vp = cam.view_projection_matrix()
    cp = np.asarray(cam.position, np.float32)
    table = JTF.from_points([(0.0, 10, 200, 30), (0.4, 250, 20, 90), (1.0, 5, 5, 250)],
                            [(0.0, 0.3), (1.0, 0.9)]).table
    kw = dict(width=W, height=H, depth_cue_strength=0.6,
              background_color=(0.9, 0.8, 0.7, 0.5))
    jbasis = jop._ray_basis_from_view_proj(jnp.asarray(vp))
    tbasis = top._ray_basis_from_view_proj(torch.tensor(vp))
    np.testing.assert_allclose(tbasis.numpy(), np.asarray(jbasis), rtol=1e-6, atol=1e-7)
    j = jpl.shade_gbuffer(
        {k: jnp.asarray(v) for k, v in gbuf.items()}, jnp.asarray(table),
        jnp.asarray(cp), jbasis, jnp.float32(1.0), jnp.float32(1.6),
        jpl.RasterSettings(**kw),
    )
    t = tpl.shade_gbuffer(
        {k: torch.tensor(v) for k, v in gbuf.items()}, torch.tensor(table),
        torch.tensor(cp), tbasis, torch.tensor(1.0), torch.tensor(1.6),
        tpl.RasterSettings(**kw),
    )
    assert t.shape == (4, H, W)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def _renderer_settings(cls, w, h):
    # linevis_tpu/render/renderer.py: OpaqueLineRenderer.render with
    # tubeGeometry 'triangle' and depth_cue_strength 0.2 (tile 32x16).
    c_pts, o_pts = TransferFunction.standard().as_static_points()
    return cls(width=w, height=h, tile_w=32, tile_h=16, depth_cue_strength=0.2,
               tf_color=c_pts, tf_opacity=o_pts)


def test_render_opaque_image_matches_jax_and_golden():
    """The golden scene (tests/golden_scenes.py scene_triangle_tubes: the
    Opaque renderer with tubeGeometry 'triangle' on _line_data(seed=11,
    width=0.04), supersample 2) through both packages, and against the
    checked-in golden."""
    w, h = 160, 120
    pos, mask, attrs = _golden_walk()
    jm = jtubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02,
                                         num_subdivisions=8)
    jimg = jop.render_opaque_image(
        jm, JCamera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h),
        tf=JTF.standard(), settings=_renderer_settings(jpl.RasterSettings, w, h),
        supersample=2,
    )
    tm = tube_mesh_from_numpy(_jax_mesh_dict(jm), device="cpu")
    cam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h)
    S = _renderer_settings(tpl.RasterSettings, w, h)
    timg = top.render_opaque_image(tm, cam, tf=TransferFunction.standard(),
                                   settings=S, supersample=2)
    assert timg.shape == (h, w, 4) and np.isfinite(timg).all()
    assert ssim(timg[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(timg - jimg).mean() <= 2e-3

    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(timg), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3

    # The converted mesh and the port's own build_tube_triangle_mesh render
    # the same image.
    built = top.render_opaque_image(_golden_mesh(), cam, settings=S, supersample=2)
    assert ssim(built[..., :3], timg[..., :3]) >= 0.999
    assert np.abs(built - timg).mean() <= 2e-3


def test_rasterize_gbuffer_reports_overflow():
    W, H = 96, 64
    cam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=W, height=H)
    vp = torch.tensor(cam.view_projection_matrix())
    S = tpl.RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=16)
    gbuf, depth, batch, overflow = top.rasterize_gbuffer(_golden_mesh(), vp, S)
    assert int(overflow) == 0 and gbuf["id"].shape == depth.shape == (H, W)
    assert set(gbuf) == {"id", "inv_w", "attr_w", "nx", "ny", "nz", "tx", "ty", "tz"}
    assert (gbuf["id"] >= 0).sum() > 100 and bool((depth[gbuf["id"] < 0] == 2.0).all())
    small = dataclasses.replace(S, pairs_capacity=64)
    assert int(top.rasterize_gbuffer(_golden_mesh(), vp, small)[3]) > 0


def test_entry_triangle_runs_on_cpu_and_defaults_to_cuda():
    fn, args = entry_triangle(device="cpu")
    img = fn(*args)
    assert img.shape == (4, 128, 256) and bool(torch.isfinite(img).all())
    assert bool((img[:3] < 0.999).any())
    if torch.cuda.is_available():
        _, args = entry_triangle()
        assert args[0].positions.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            entry_triangle()


def test_triangle_wrapper_rejects_bad_inputs():
    t, _, tile = _binnings("soup_chunk16")
    meta = dataclasses.replace(t, payload=t.payload.to("meta"))
    with pytest.raises(ValueError):
        trp.rasterize_gbuffer(meta, 8, *tile)
    with pytest.raises(ValueError):
        trp.build_csr_binning_bbox(
            *(torch.zeros(4) for _ in range(4)), torch.zeros(12, 4),
            torch.ones(4, dtype=torch.bool), 64, 32,
        )  # payload rows not a multiple of 8
