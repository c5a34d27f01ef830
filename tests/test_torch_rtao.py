"""linevis_tpu_torch ray-traced ambient occlusion vs the JAX package on the CPU.

The AO trace tests every slot from the 128-aligned floor of a pair chunk's
first cell to the end of its last cell, so a ray's result depends on which
pairs share its chunk and on the order of records within the preceding
cell: on the two sorts. `jax.lax.sort` is unstable there and `torch.sort`
is stable, so the kernel is held level on IDENTICAL inputs (the port's pair
chunks and records, handed to the JAX kernel in interpret mode: every pair
equal), and the whole trace is bracketed per ray:

    occluded by the sampled cells alone <= traced <= occluded by any segment

Bars, each stated where it is checked: grid cell arrays identical; the
kernel's plain version equal to the JAX kernel on every pair; port and JAX
traces inside the bracket on every ray; at most 3 of 128 rays against the
float64 brute force (the JAX package's own bar); images at SSIM >= 0.999 and
mean abs <= 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels import ao_grid as jao
from linevis_tpu.render import rtao as jrtao
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import capsule_scene_from_numpy, segment_grid_from_numpy
from linevis_tpu_torch.entry import entry_rtao
from linevis_tpu_torch.kernels import ao_grid as tao
from linevis_tpu_torch.render import rtao as trtao
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.pipeline import RasterSettings

from tests.test_capsule_raster import _ray_capsule_np

torch.set_num_threads(1)

W, H = 64, 48


def _walk(seed=12345, L=12, P=6, radius=0.03):
    # tests/test_rtao.py:_random_scene's inputs.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.08, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _scenes(**kw):
    pos, mask, attrs, radius = _walk(**kw)
    js = jtr.build_capsule_scene(pos, mask, attrs, radius=radius)
    ts = capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}, "cpu"
    )
    return js, ts


def _grids(js, ts, resolution=16):
    jg = jao.build_segment_grid(js.a, js.ba, js.radius, js.mask, resolution=resolution)
    tg = tao.build_segment_grid(ts.a, ts.ba, ts.radius, ts.mask, resolution=resolution)
    return jg, tg


def _grid_to_port(jg):
    return segment_grid_from_numpy({
        **{n: np.asarray(getattr(jg, n))
           for n in ("records", "cell_start", "cell_count", "origin", "inv_cell")},
        "resolution": jg.resolution, "chunk": jg.chunk,
    }, "cpu")


def _rays(seed=5, n_rays=128, t_max=0.25):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 0.3, (3, n_rays)).astype(np.float32)
    d = rng.normal(0, 1, (3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o, d, np.full((n_rays,), t_max, np.float32), np.ones((n_rays,), bool)


def _bracket(o, d, t_max, grid, max_ray_cells=8):
    """(lower, upper) bool [R]: occluded by a segment of a sampled cell, and
    by any segment of the grid, with the kernel's own float32 hit test."""
    o, d, t_max = (torch.as_tensor(x) for x in (o, d, t_max))
    n_valid = int(grid.cell_start[-1] + grid.cell_count[-1])
    seg = grid.records[:, :n_valid]
    ray = tuple(x[None, None, :] for x in (*o, *d, t_max))
    hit = tao._any_hit(ray, seg[:, None, :, None])[0]  # [slots, R]
    G = grid.resolution
    cell_of_slot = torch.repeat_interleave(torch.arange(G ** 3), grid.cell_count.long())
    ts = torch.linspace(0.0, 1.0, max_ray_cells)
    p = o[:, None, :] + d[:, None, :] * (ts[None, :, None] * t_max[None, None, :])
    cc = tao._cell_index((p - grid.origin[:, None, None]) * grid.inv_cell[:, None, None], G)
    cell = (cc[2] * G + cc[1]) * G + cc[0]  # [M, R]
    lower = torch.zeros(o.shape[1], dtype=torch.bool)
    for m in range(max_ray_cells):
        lower |= (hit & (cell_of_slot[:, None] == cell[m][None, :])).any(dim=0)
    return lower.numpy(), hit.any(dim=0).numpy()


def test_auto_grid_span_matches_jax():
    js, ts = _scenes()
    for res in (16, 64):
        assert tao.auto_grid_span(ts.a.numpy(), ts.ba.numpy(), ts.radius, res) == \
            jao.auto_grid_span(np.asarray(js.a), np.asarray(js.ba), js.radius, res)


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "masked"])
def test_segment_grid_matches_jax(masked):
    """cell_start, cell_count, origin, inv_cell identical; every cell's run
    the same multiset of record columns (the order within a cell is the
    sort's business), rows 0-6 bit for bit and ba.ba within one ulp. The
    sentinel tail is unhittable in both."""
    js, ts = _scenes()
    if masked:
        m = np.ones(js.mask.shape, bool)
        m[::5] = False
        js = dataclasses.replace(js, mask=jnp.asarray(m))
        ts = dataclasses.replace(ts, mask=torch.as_tensor(m))
    jg, tg = _grids(js, ts)
    for name in ("cell_start", "cell_count", "origin", "inv_cell"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy(), err_msg=name)
    assert (jg.resolution, jg.chunk) == (tg.resolution, tg.chunk)
    jr, tr = np.asarray(jg.records), tg.records.numpy()
    assert jr.shape == tr.shape
    start, count = tg.cell_start.numpy(), tg.cell_count.numpy()
    assert count.sum() > 0
    for c in np.nonzero(count)[0]:
        a = jr[:, start[c]:start[c] + count[c]]
        b = tr[:, start[c]:start[c] + count[c]]
        a, b = (x[:, np.lexsort(x[6::-1])] for x in (a, b))
        np.testing.assert_array_equal(a[:7], b[:7])
        # Row 7, ba.ba: XLA:CPU contracts the sum of products, one ulp apart.
        np.testing.assert_allclose(a[7], b[7], rtol=2.4e-7, atol=0)
    n_valid = int(count.sum())
    assert (tr[0:3, n_valid:] == 1e10).all() and (jr[0:3, n_valid:] == 1e10).all()


def test_trace_pairs_reference_matches_jax_kernel():
    """The kernel's plain version against the JAX kernel (interpret mode) on
    the SAME pair chunks and records (the port's): every pair equal, 0/1
    exactly. Rays start on tube surfaces, as AO rays do, so that many chunks
    hold hits and some saturate."""
    js, ts = _scenes()
    _, tg = _grids(js, ts)
    rng = np.random.default_rng(3)
    n_rays = 1000  # not a multiple of the chunk: the last chunk is padded
    seg = rng.integers(0, ts.num_segments, n_rays)
    u = rng.uniform(0, 1, n_rays).astype(np.float32)
    o = (ts.a.numpy()[:, seg] + u * ts.ba.numpy()[:, seg]
         + rng.normal(0, 0.04, (3, n_rays))).astype(np.float32)
    d = rng.normal(0, 1, (3, n_rays)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    t_max = np.full((n_rays,), 0.2, np.float32)
    pairs = tao.expand_ray_pairs(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.ones(n_rays, dtype=torch.bool), tg,
    )
    walked = torch.zeros(pairs.seg_begin.shape[0], dtype=torch.int32)
    tests = torch.zeros_like(walked)
    occ_t = tao.trace_pairs(pairs.rays, pairs.seg_begin, pairs.seg_chunks, tg.records,
                            tg.chunk, walked=walked, tests=tests).numpy()
    occ_j = np.asarray(jao._trace_pairs(
        jnp.asarray(pairs.rays.numpy()), jnp.asarray(pairs.seg_begin.numpy()),
        jnp.asarray(pairs.seg_chunks.numpy()), jnp.asarray(tg.records.numpy()),
        tg.chunk, True,
    ))
    assert set(np.unique(occ_t)) <= {0.0, 1.0}
    n_chunks = pairs.seg_begin.shape[0]
    assert n_chunks % 8 != 0  # the JAX kernel pads its grid; the port does not
    assert (pairs.seg_chunks == 0).any() and (pairs.seg_chunks > 1).any()
    assert (walked <= pairs.seg_chunks).all()
    # The needed tests: at most every slot x ray of a walked record chunk,
    # fewer where slots are unhittable or rays were occluded before; a pair
    # chunk that walks one record chunk tests its hittable slots for all rays.
    assert (tests <= walked * 128 * 128).all() and (tests < walked * 128 * 128).any()
    one = torch.nonzero(walked == 1).flatten()
    slots = tg.records[0, pairs.seg_begin[one].long()[:, None] + torch.arange(128)] < 1e9
    assert one.numel() > 0 and torch.equal(tests[one], (128 * slots.sum(dim=1)).int())
    assert occ_t.sum() > 100
    differ = np.nonzero(occ_t != occ_j)[0]
    assert differ.size == 0, [(int(i), pairs.rays[:, i].tolist()) for i in differ[:5]]


def test_trace_ao_occlusion_vs_jax_and_bruteforce():
    """Port and JAX on the same rays and the same grid (JAX's, carried
    across). Rays on which the two differ are counted; every ray of either
    lies inside the bracket; and the port meets the JAX package's own bar
    against the float64 brute force (at most 3 of 128 rays)."""
    js, ts = _scenes()
    jg, _ = _grids(js, ts)
    tg = _grid_to_port(jg)
    o, d, t_max, valid = _rays()
    occ_t = tao.trace_ao_occlusion(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(valid), tg,
    ).numpy()
    occ_j = np.asarray(jao.trace_ao_occlusion(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(valid), jg,
        interpret=True,
    ))
    lower, upper = _bracket(o, d, t_max, tg)
    for name, occ in (("port", occ_t), ("jax", occ_j)):
        occ = occ > 0.5
        assert (lower <= occ).all() and (occ <= upper).all(), name
    # Measured: 0 of 128 rays differ on this scene (the sorts agree here).
    assert (occ_t != occ_j).sum() <= 2
    assert 10 < occ_t.sum() < 128

    a_np, ba_np = ts.a.numpy().T, ts.ba.numpy().T
    wrong = 0
    for i in range(o.shape[1]):
        tmin = min(_ray_capsule_np(o[:, i], d[:, i], a_np[s], a_np[s] + ba_np[s], ts.radius)
                   for s in range(ts.num_segments))
        wrong += (1.0 if 1e-4 < tmin < 0.25 else 0.0) != occ_t[i]
    assert wrong <= 3, f"{wrong}/128 rays disagree with the brute force"


def test_invalid_rays_are_never_occluded():
    js, ts = _scenes()
    _, tg = _grids(js, ts)
    o, d, t_max, valid = _rays(n_rays=200)
    valid[::2] = False
    occ = tao.trace_ao_occlusion(
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(valid), tg,
    ).numpy()
    assert (occ[::2] == 0).all() and occ[1::2].sum() >= 1


def _frame_args(cam_cls, settings_cls, w=W, h=H):
    cam = cam_cls(position=(0.0, 0.2, 1.2), look_at_point=(0, 0, 0), width=w, height=h)
    S = settings_cls(width=w, height=h, tile_w=16, tile_h=8, chunk=16, span_x=4, span_y=4)
    return cam, S


def _jax_uniforms(seed, frame, shape):
    """The uniforms `linevis_tpu.render.rtao` draws for this frame."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + frame))
    return (np.array(jax.random.uniform(k1, shape)),
            np.array(jax.random.uniform(k2, shape)))


@pytest.mark.parametrize("frame", [0, 3])
def test_render_rtao_matches_jax(frame):
    """Whole frame, the same uniforms in both: SSIM >= 0.999 and mean abs <=
    2e-3 (measured 0.9999999999 and 2.8e-7). The port's default draw equals
    JAX's uniforms bit for bit, so the frame without `uniforms=` is the
    same frame. The port's AO map against the JAX trace of the port's own
    rays: mean abs <= 1e-3."""
    js, ts = _scenes()
    jcam, jS = _frame_args(JCamera, JSettings)
    tcam, tS = _frame_args(Camera, RasterSettings)
    jr = jrtao.RtaoSettings(num_samples=2, ao_radius=0.2, grid_resolution=16, seed=7)
    tr = trtao.RtaoSettings(num_samples=2, ao_radius=0.2, grid_resolution=16, seed=7)
    img_j = np.asarray(jrtao.render_tubes_rtao(
        js, jnp.asarray(jcam.view_projection_matrix()),
        jnp.asarray(np.asarray(jcam.position, np.float32)),
        jnp.asarray(jtr._proj_constants(jcam)), jS, jr, frame=frame,
    ))
    u1, u2 = _jax_uniforms(7, frame, (2, H, W))
    cam_t = ttr.camera_tensors(tcam, "cpu")
    uniforms = (torch.as_tensor(u1), torch.as_tensor(u2))
    # The port's own draw is jax.random's, bit for bit.
    t1, t2 = trtao.hemisphere_uniforms(trtao.threefry.prng_key(7 + frame), (2, H, W))
    assert np.array_equal(t1.numpy().view(np.int32), u1.view(np.int32))
    assert np.array_equal(t2.numpy().view(np.int32), u2.view(np.int32))
    before = tao.trace_pairs.launches
    img_t = trtao.render_tubes_rtao(ts, *cam_t, tS, tr, frame=frame, uniforms=uniforms)
    assert tao.trace_pairs.launches == before  # no kernel launch on the CPU
    # Without uniforms= the frame draws the same samples itself.
    assert torch.equal(trtao.render_tubes_rtao(ts, *cam_t, tS, tr, frame=frame), img_t)
    img_t = img_t.numpy()
    assert img_t.shape == img_j.shape == (4, H, W) and np.isfinite(img_t).all()
    s_ = ssim(np.moveaxis(img_t[:3], 0, -1), np.moveaxis(img_j[:3], 0, -1))
    mad = float(np.abs(img_t - img_j).mean())
    assert s_ >= 0.999 and mad <= 2e-3, (s_, mad)

    # The AO map, step by step as the renderer takes them.
    gbuf = trtao.rtao_gbuffer(ts, *cam_t, tS)
    o, d, t_max, valid = trtao.rtao_rays(gbuf, ts.radius, tr, *uniforms)
    grid = tao.build_segment_grid(ts.a, ts.ba, ts.radius, ts.mask, resolution=16)
    ao_t = 1.0 - trtao.trace_ao_batched(o, d, t_max, valid, grid, tr).reshape(2, H, W).mean(0)
    np.testing.assert_array_equal(trtao.rtao_shade(gbuf, ao_t, tS).numpy(), img_t)
    fg = gbuf.fg.numpy()
    assert fg.mean() > 0.05 and (ao_t.numpy()[fg] < 1.0).mean() > 0.1
    jg, _ = _grids(js, ts)
    occ_j = np.asarray(jao.trace_ao_occlusion(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(t_max.numpy()),
        jnp.asarray(valid.numpy()), jg, interpret=True,
    ))
    ao_j = 1.0 - occ_j.reshape(2, H, W).mean(axis=0)
    assert float(np.abs(ao_t.numpy() - ao_j).mean()) <= 1e-3


def test_ray_batching_in_the_port():
    """`rays_per_batch=1024` (4 batches of 2 x 64 x 32 rays) against the
    single shot. A ray's result may depend on the pairs that share its
    chunk, so the two are not equal by construction: what is measured on
    this scene is that no pixel differs (the JAX package's own test holds
    its two paths equal on the same scene), every batched ray lies inside
    the bracket, and the batch boundaries are multiples of 128."""
    js, ts = _scenes()
    tcam, tS = _frame_args(Camera, RasterSettings, 64, 32)
    cam_t = ttr.camera_tensors(tcam, "cpu")
    base = trtao.RtaoSettings(num_samples=2, ao_radius=0.2, grid_resolution=16,
                              rays_per_batch=0)
    batched = dataclasses.replace(base, rays_per_batch=1024)
    assert trtao.ray_batches(4096, 1024) == [(i, i + 1024) for i in range(0, 4096, 1024)]
    assert trtao.ray_batches(4097, 1024) == [(0, 896), (896, 1792), (1792, 2688),
                                             (2688, 3584), (3584, 4097)]
    one = trtao.render_tubes_rtao(ts, *cam_t, tS, base).numpy()
    many = trtao.render_tubes_rtao(ts, *cam_t, tS, batched).numpy()
    np.testing.assert_array_equal(one, many)

    gbuf = trtao.rtao_gbuffer(ts, *cam_t, tS)
    gen = torch.Generator().manual_seed(0)
    u1, u2 = (torch.rand((2, 32, 64), generator=gen) for _ in range(2))
    o, d, t_max, valid = trtao.rtao_rays(gbuf, ts.radius, base, u1, u2)
    grid = tao.build_segment_grid(ts.a, ts.ba, ts.radius, ts.mask, resolution=16)
    occ = trtao.trace_ao_batched(o, d, t_max, valid, grid, batched).numpy() > 0.5
    lower, upper = _bracket(o.numpy(), d.numpy(), t_max.numpy(), grid)
    v = valid.numpy()
    assert (lower[v] <= occ[v]).all() and (occ <= upper).all() and not occ[~v].any()


def test_rtao_image_accumulates_and_unported_options_raise():
    js, ts = _scenes()
    tcam, tS = _frame_args(Camera, RasterSettings, 64, 32)
    rt = trtao.RtaoSettings(num_samples=1, ao_radius=0.2, grid_resolution=16)
    one = trtao.render_tubes_rtao_image(ts, tcam, settings=tS, rtao=rt)
    four = trtao.render_tubes_rtao_image(ts, tcam, settings=tS, rtao=rt, accumulate_frames=4)
    assert one.shape == four.shape == (32, 64, 4) and np.isfinite(four).all()
    assert not np.array_equal(one, four)  # frames draw different samples
    img, (pos, normal, fg) = trtao.render_tubes_rtao(
        ts, *ttr.camera_tensors(tcam, "cpu"), tS, rt, return_features=True
    )
    assert pos.shape == normal.shape == (3, 32, 64) and fg.dtype == torch.bool
    cam_t = ttr.camera_tensors(tcam, "cpu")
    # The denoisers are ported: EAW filters the AO map, alpha stays.
    den = trtao.render_tubes_rtao(ts, *cam_t, tS, dataclasses.replace(rt, denoiser="EAW"))
    raw = trtao.render_tubes_rtao(ts, *cam_t, tS, rt)
    assert bool(torch.isfinite(den).all()) and not torch.equal(den, raw)
    assert torch.equal(den[3], raw[3])
    with pytest.raises(NotImplementedError, match="item 10"):
        trtao.render_tubes_rtao(ts, *cam_t, tS, rt, psum_axis="rays")


def test_entry_rtao_runs_on_cpu():
    fn, args = entry_rtao(device="cpu")
    img = fn(*args).numpy()
    assert img.shape == (4, 128, 256) and np.isfinite(img).all()
    assert (img[:3] < 0.999).any(axis=0).mean() > 0.05
    fn2, args2 = entry_rtao(device="cpu")
    np.testing.assert_array_equal(img, fn2(*args2).numpy())  # seeded samples
