"""linevis_tpu_torch.parallel (multi-GPU through torch.distributed) vs the JAX
package on the CPU.

The ranks are threads of the test process, each with a gloo process group of
its own on one in-memory store (`parallel/mesh.py:run_ranks`): no network
port. The JAX sharded functions cost 5-75 s of interpret-mode compiles each
at n=2, so the bands are held against the JAX package band by band, through
the JAX functions that run outside `shard_map` with one band's arguments, and
the sharded results against the port's own single-device results at the JAX
package's own sharded bars (`tests/test_multichip.py`). Bars, each stated
where it is checked:
- `fold_in` equals `jax.random.fold_in` bit for bit;
- band-local `prepare_capsule_frame`: tile starts and counts equal to JAX's,
  each run the same pairs with rows within float32 rounding (the bar of
  `tests/test_torch_binning.py`), params within 2 ulp (measured: bit for
  bit), whole tiles a band or not;
- opaque at n=4, 128x64: each band's CSR binning identical to JAX's band
  steps (`mesh.py:63-80`), the JAX `_shade_band` of the port's band
  G-buffer within 1e-5 of the port's band (measured: bit for bit); the
  frame against the single-device frame at `test_multichip.py:36-44`'s
  flip bar and the ROADMAP image bars (SSIM >= 0.999, mean abs <= 2e-3);
- MLAB at n=8, 32x64: the JAX band resolve (`mesh.py:236-262`) of the
  port's nodes within 1e-6 of the port's band; the frame against the
  single-device frame at `test_multichip.py:96-99`;
- RTAO at n=8: each rank's uniforms equal jax.random's at
  `fold_in(PRNGKey(seed + frame), rank)` bit for bit, a rank's trace inside
  the per-ray bracket of `tests/test_torch_rtao.py`, the average exact (4
  samples: sums of quarters), the property of `test_multichip.py:102-175`;
- the opacity solve at n=8 against the single-device solve at
  `test_multichip.py:224-227` (at n=2 against JAX's sharded solve:
  `tests/test_torch_opacity_optimization.py::test_band_axis_raises`);
- VPT at n=2 against JAX's `render_vpt_sharded` on the conftest's virtual
  devices at `tests/test_torch_vpt.py`'s bar (>= 95% of pixels within
  1e-4), the port's average exactly that of its ranks' frames;
- a world of one through `make_device_mesh` (gloo): each sharded function
  bit for bit with the single-device function on the same draws;
- `entry.dryrun_multichip(2, device="cpu")`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from linevis_tpu.kernels import raster_pallas as jrp
from linevis_tpu.parallel import mesh as jmesh
from linevis_tpu.render import oit as joit
from linevis_tpu.render import opaque as jop
from linevis_tpu.render import pipeline as jpl
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render import vpt as jvpt
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch import entry
from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
from linevis_tpu_torch.kernels import ao_grid as tao
from linevis_tpu_torch.kernels import raster_pallas as trp
from linevis_tpu_torch.kernels.raster_capsule_oit import rasterize_capsules_mlab
from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.ops import threefry
from linevis_tpu_torch.parallel import mesh as pm
from linevis_tpu_torch.render import opacity_optimization as too
from linevis_tpu_torch.render import rtao as trtao
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render import vpt as tvpt
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.oit import prepare_mlab_frame, render_tubes_mlab
from linevis_tpu_torch.render.opaque import render_opaque, untile_gbuffer
from linevis_tpu_torch.render import pipeline as tpl
from linevis_tpu_torch.render.pipeline import GBUFFER_PLANES, RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction

from tests.test_torch_rtao import _bracket

torch.set_num_threads(1)


def _ranks(n, fn):
    """fn(group) on n gloo ranks -> [rank r's result]."""
    return pm.run_ranks(n, lambda group, dev: fn(group))


def _walk_scene(seed, L, P, radius):
    """tests/test_multichip.py's random-walk capsule scenes, in both packages."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    args = (pos, np.ones((L, P), bool), rng.uniform(0, 1, (L, P)).astype(np.float32))
    return (jtr.build_capsule_scene(*args, radius=radius),
            ttr.build_capsule_scene(*args, radius=radius, device="cpu"))


def _jax_cam(cam):
    return (jnp.asarray(cam.view_projection_matrix()),
            jnp.asarray(np.asarray(cam.position, np.float32)),
            jnp.asarray(jtr._proj_constants(cam)))


def _tiny_mesh():
    """`__graft_entry__._tiny_scene()`: the entry lines as triangle tubes of
    4 subdivisions, on the CPU."""
    return build_tube_triangle_mesh(*entry._small_lines(), radius=0.02, num_subdivisions=4,
                                    device="cpu")


def test_fold_in_matches_jax():
    for seed in (0, 7, 123456, 2**31 + 5, 2**32 - 1):
        for data in (*range(8), 2**31 - 1, 2**32 - 1):
            j = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
            t = threefry.fold_in(threefry.prng_key(seed), data)
            assert t.dtype == torch.int64 and t.shape == (2,)
            np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    # Batched keys [..., 2] (jax.random.fold_in takes one key: vmapped).
    keys = jax.random.split(jax.random.PRNGKey(3), 6).reshape(2, 3, 2)
    j = np.asarray(jax.vmap(jax.vmap(lambda k: jax.random.fold_in(k, 9)))(keys))
    t = threefry.fold_in(torch.tensor(np.asarray(keys).astype(np.int64)), 9)
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    for bad in (-1, 2**32):
        with pytest.raises(ValueError):
            threefry.fold_in(threefry.prng_key(0), bad)


def _runs_match(jc, tc):
    """tests/test_torch_binning.py's bar: tile starts and counts equal, each
    run the same pairs by id, rows within float32 rounding (XLA contracts the
    projection's products into FMAs)."""
    ts, tn = tc.tile_start.numpy(), tc.tile_count.numpy()
    np.testing.assert_array_equal(ts, np.asarray(jc.tile_start))
    np.testing.assert_array_equal(tn, np.asarray(jc.tile_count))
    jp, tp = np.asarray(jc.payload), tc.payload.numpy()
    assert jp.shape == tp.shape
    for s, c in zip(ts, tn):
        a, b = jp[:, s:s + c], tp[:, s:s + c]
        a = a[:, np.argsort(a[9], kind="stable")]
        b = b[:, np.argsort(b[9], kind="stable")]
        np.testing.assert_array_equal(a[9], b[9])
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("W,H,n", [(32, 72, 3), (64, 128, 4), (64, 128, 3)])
def test_band_prep_matches_jax(W, H, n):
    """Every band of n (64x128 over 3: 42 rows, not whole 8-row tiles)."""
    js, ts = _walk_scene(9, 6, 6, 0.04)
    jcam = JCamera(position=(0.0, 0.1, 1.2), width=W, height=H)
    tcam = ttr.camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H), "cpu")
    kw = dict(width=W, height=H // n, tile_w=16, tile_h=8, chunk=8, span_x=3, span_y=3)
    pairs = 0
    jprep = jax.jit(lambda y0: jtr.prepare_capsule_frame(
        js, *_jax_cam(jcam), JSettings(**kw), y_offset=y0, full_height=H)[:2])
    for band in range(n):
        y0 = band * (H // n)
        jc, jp = jprep(jnp.float32(y0))
        tc, tp, _ = ttr.prepare_capsule_frame(ts, *tcam, RasterSettings(**kw), y_offset=y0,
                                              full_height=H)
        _runs_match(jc, tc)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2.4e-7, atol=0)
        pairs += int(tc.tile_count.sum())
    assert pairs > 50
    with pytest.raises(ValueError):
        ttr.prepare_capsule_frame(ts, *tcam, RasterSettings(**kw), y_offset=0)


def test_opaque_bands_match_jax_and_single_device():
    tm = _tiny_mesh()
    n, W = 4, 128
    H = 8 * n * 2
    cam = Camera(position=(0.0, 0.3, 1.2), width=W, height=H)
    S = RasterSettings(width=W, height=H, chunk=64)
    bs = dataclasses.replace(S, height=H // n)
    jbs = JSettings(width=W, height=H // n, chunk=64)
    vp, cp, _ = ttr.camera_tensors(cam, "cpu")
    table = torch.tensor(TransferFunction.standard().table)
    frames = _ranks(n, lambda g: pm.render_opaque_sharded(tm, vp, cp, table, S, g))
    assert all(torch.equal(f, frames[0]) for f in frames)
    frame = frames[0].numpy()
    jvp = jnp.asarray(vp.numpy())
    jbasis = jop._ray_basis_from_view_proj(jvp)
    tbasis = pm._ray_basis_from_view_proj(vp)

    # linevis_tpu/parallel/mesh.py:_render_band's band steps on the port's
    # band batch (the vertex stage is held in tests/test_torch_triangles.py).
    jax_binning = jax.jit(lambda x, y, p, v: jrp.build_csr_binning(
        x, y, p, v, W, bs.height, jbs.tile_w, jbs.tile_h, jbs.chunk, jbs.span_x, jbs.span_y,
        jbs.pairs_capacity))
    jax_shade = jax.jit(lambda g, dmin, dmax, band: jmesh._shade_band(
        g, jnp.asarray(table.numpy()), jnp.asarray(cp.numpy()), jbasis, dmin, dmax, jbs, band,
        n))
    full = tpl.tube_vertex_stage(tm, vp, W, H)
    for band in range(n):
        jb = jpl.TriangleBatch(**{
            f.name: (tuple(jnp.asarray(c.numpy()) for c in getattr(full, f.name))
                     if isinstance(getattr(full, f.name), tuple)
                     else jnp.asarray(getattr(full, f.name).numpy()))
            for f in dataclasses.fields(full)})
        jb = dataclasses.replace(jb, tri_y=jb.tri_y - jnp.float32(band * bs.height))
        jc = jax_binning(jb.tri_x, jb.tri_y, jpl.build_payload(jb), jb.tri_valid)
        batch, tc = pm._band_binning(tm, vp, bs, band, n)
        for f in ("tile_chunk_base", "tile_num_chunks", "overflow", "payload"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
        gbuf, _ = untile_gbuffer(tc, trp.rasterize_gbuffer(tc, GBUFFER_PLANES, bs.tile_w,
                                                           bs.tile_h), bs)
        t_band = pm._shade_band(gbuf, table, cp, tbasis, batch.view_z_min, batch.view_z_max,
                                bs, band, n).numpy()
        j_band = np.asarray(jax_shade({k: jnp.asarray(v.numpy()) for k, v in gbuf.items()},
                                      jnp.asarray(batch.view_z_min.numpy()),
                                      jnp.asarray(batch.view_z_max.numpy()), jnp.int32(band)))
        np.testing.assert_allclose(t_band, j_band, rtol=0, atol=1e-5)
        rows = slice(band * bs.height, (band + 1) * bs.height)
        np.testing.assert_array_equal(frame[:, rows], t_band)
    single = render_opaque(tm, vp, cp, table, S).numpy()
    # test_multichip.py:36-44: band-local pixel coordinates flip coverage on
    # few edge pixels (< 0.5%; measured 0.16%). Its second bar, the other
    # pixels within 5e-3, holds JAX's own frames but not this pair: one
    # pixel differs at 6e-3 through the planes' float32 rounding (ROADMAP
    # C9) raised to the specular power 30, where the port's single-device
    # frame already differs from JAX's.
    # The other pixels are held to the ROADMAP image bars.
    diff = np.abs(single - frame)
    assert (diff > 1e-2).any(axis=0).mean() < 0.005
    s_ = ssim(np.moveaxis(frame[:3], 0, -1), np.moveaxis(single[:3], 0, -1))
    assert s_ >= 0.999 and diff.mean() <= 2e-3, (s_, diff.mean())
    assert (frame[3] > 0.5).mean() > 0.05  # the lines cover the frame


def test_mlab_bands_match_jax_and_single_device():
    js, ts = _walk_scene(9, 6, 6, 0.04)
    n, W, H, K, opacity = 8, 32, 64, 4, 0.4
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=8, span_x=3, span_y=3)
    bs = dataclasses.replace(S, height=H // n)
    jbs = JSettings(width=W, height=H // n, tile_w=16, tile_h=8, chunk=8, span_x=3, span_y=3)
    cam = Camera(position=(0.0, 0.1, 1.2), width=W, height=H)
    tcam = ttr.camera_tensors(cam, "cpu")
    jcam = _jax_cam(JCamera(position=(0.0, 0.1, 1.2), width=W, height=H))
    frames = _ranks(n, lambda g: pm.render_tubes_mlab_sharded(ts, *tcam, S, g, K=K,
                                                              opacity=opacity))
    assert all(torch.equal(f, frames[0]) for f in frames)
    frame = frames[0].numpy()

    @jax.jit
    def jax_resolve(jd, jf, ja, dmin, dmax):
        """JAX's band resolve of a band's nodes (linevis_tpu/parallel/mesh.py:236-262)."""
        from linevis_tpu.kernels.tiles import unpack_tiles

        rgb = joit.shade_deferred_nodes(jd, jf, ja, jcam[2], dmin, dmax,
                                        jnp.float32(jbs.depth_cue_strength), jbs)
        T = jnp.ones_like(ja[0])
        acc = jnp.zeros((3,) + ja.shape[1:], jnp.float32)
        for i in range(K):
            acc = acc + T[None] * rgb[:, i]
            T = T * (1.0 - ja[i])
        out = acc + T[None] * jnp.asarray(jbs.background_color, jnp.float32)[:3, None, None]
        return jnp.stack([unpack_tiles(p, W // 16, 1, 16, 8, W, 8)
                          for p in (out[0], out[1], out[2], 1.0 - T)])

    for band in (2, 5):
        csr, params = prepare_mlab_frame(ts, *tcam, bs, opacity, y_offset=band * bs.height,
                                         full_height=H)
        _, jp, _ = jtr.prepare_capsule_frame(js, *jcam, jbs, y_offset=jnp.float32(band * 8),
                                             full_height=H)
        np.testing.assert_array_equal(params[:11].numpy(), np.asarray(jp)[:11])
        depths, feat, alpha = rasterize_capsules_mlab(
            csr, params, W, bs.height, 16, 8, K, bs.tf_color, bs.tf_opacity,
            deferred_shade=True)
        j_band = np.asarray(jax_resolve(
            *(jnp.asarray(x.numpy()) for x in (depths, feat, alpha, params[11], params[12]))))
        rows = slice(band * bs.height, (band + 1) * bs.height)
        np.testing.assert_allclose(frame[:, rows], j_band, rtol=0, atol=1e-6)
        assert (j_band[3] > 0.01).any()
    single = render_tubes_mlab(ts, *tcam, S, K=K, opacity=opacity).numpy()
    diff = np.abs(frame - single)  # test_multichip.py:96-99
    assert diff.mean() < 1e-3 and (diff > 0.02).mean() < 0.01 and diff.max() < 0.2


def _rtao_scene():
    """test_multichip.py:102-175: a lower slab under a grating with gaps."""
    L = 8
    pos = np.zeros((L, 2, 3), np.float32)
    for i in range(4):
        pos[i, 0] = (-0.4, 0.0, -0.08 + 0.05 * i)
        pos[i, 1] = (0.4, 0.0, -0.08 + 0.05 * i)
        pos[4 + i, 0] = (-0.18 + 0.12 * i, 0.18, -0.4)
        pos[4 + i, 1] = (-0.18 + 0.12 * i, 0.18, 0.4)
    scene = ttr.build_capsule_scene(
        pos, np.ones((L, 2), bool), np.linspace(0, 1, 2 * L, dtype=np.float32).reshape(L, 2),
        radius=0.03, device="cpu")
    W, H = 32, 16
    cam = ttr.camera_tensors(Camera(position=(0.0, 0.5, 0.9), look_at_point=(0, 0, 0),
                                    width=W, height=H), "cpu")
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=16, span_x=3, span_y=3)
    return scene, cam, S


def test_rtao_ranks_draw_jax_fold_in_and_average():
    scene, cam, S = _rtao_scene()
    n, (H, W) = 8, (S.height, S.width)
    rtao = trtao.RtaoSettings(num_samples=4, grid_resolution=16, ao_radius=0.3)
    grid = tao.build_segment_grid(scene.a, scene.ba, scene.radius, scene.mask, resolution=16)
    frames = _ranks(n, lambda g: pm.render_tubes_rtao_sharded(scene, *cam, S, g, rtao=rtao,
                                                              grid=grid))
    again = _ranks(n, lambda g: pm.render_tubes_rtao_sharded(scene, *cam, S, g, rtao=rtao,
                                                             grid=grid))
    assert all(torch.equal(f, frames[0]) for f in frames + again)  # deterministic
    occ = []
    for r in range(n):
        u1, u2 = trtao.hemisphere_uniforms(threefry.fold_in(threefry.prng_key(rtao.seed), r),
                                           (4, H, W))
        if r in (0, 1, n - 1):
            # Rank r's draws are jax.random's at fold_in(PRNGKey(seed + frame), r).
            k1, k2 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(rtao.seed), r))
            for t, k in ((u1, k1), (u2, k2)):
                j = np.asarray(jax.random.uniform(k, (4, H, W)))
                np.testing.assert_array_equal(t.numpy().view(np.int32), j.view(np.int32))
        gbuf, o = trtao.rtao_occlusion(scene, *cam, S, rtao, grid=grid, rank=r)
        occ.append(o)
        if r == 1:  # the trace of a rank's rays inside the per-ray bracket
            rays = trtao.rtao_rays(gbuf, scene.radius, rtao, u1, u2)
            traced = trtao.trace_ao_batched(*rays, grid, rtao).numpy() > 0.5
            lower, upper = _bracket(*(x.numpy() for x in rays[:3]), grid)
            v = rays[3].numpy()
            assert (lower[v] <= traced[v]).all() and (traced <= upper).all()
    # Means of 4 samples are quarters: their sum is exact in any order.
    mean = vdiv(torch.stack(occ).sum(dim=0), n)
    assert torch.equal(frames[0], trtao.rtao_image(gbuf, mean, cam[1], S, rtao))
    single4 = trtao.render_tubes_rtao(scene, *cam, S, rtao, grid=grid).numpy()
    reference = trtao.render_tubes_rtao(
        scene, *cam, S, dataclasses.replace(rtao, num_samples=64, seed=99), grid=grid).numpy()
    assert float(np.abs(reference - single4).max()) > 1e-3  # AO is not binary here
    err_sharded = float(np.mean((frames[0].numpy() - reference) ** 2))
    err_single = float(np.mean((single4 - reference) ** 2))
    assert err_sharded < err_single, (err_sharded, err_single)


def test_opacity_solve_bands_match_single_device():
    _, ts = _walk_scene(11, 5, 7, 0.03)
    L, P, W, H = 5, 7, 64, 128
    cam = ttr.camera_tensors(Camera(position=(0.0, 0.1, 1.2), width=W, height=H), "cpu")
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=16, span_x=3, span_y=3)
    oo = too.OpacityOptimizationSettings(opacity_resolution_scale=1.0)
    prev = torch.ones(L, P)
    single = too.opacity_solve(ts, *cam, prev, S, oo, L, P).numpy()
    solved = _ranks(8, lambda g: pm.opacity_solve_sharded(ts, *cam, prev, S, oo, L, P, g))
    assert all(torch.equal(s, solved[0]) for s in solved)
    diff = np.abs(solved[0].numpy() - single)  # test_multichip.py:224-227
    assert (diff > 1e-3).mean() < 0.05 and np.median(diff) < 1e-6
    assert single.min() < 0.99  # some vertices fade
    with pytest.raises(TypeError):  # a JAX axis name is no group
        too.opacity_solve(ts, *cam, prev, S, oo, L, P, band_axis="y")


def _vpt_inputs():
    """__graft_entry__.dryrun_multichip's VPT scene: a 16^3 Gaussian density."""
    z = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    dens = np.exp(-8.0 * ((z[:, None, None] - 0.5) ** 2 + (z[None, :, None] - 0.5) ** 2
                          + (z[None, None, :] - 0.5) ** 2)).astype(np.float32)
    basis = np.stack([[0.6, 0, 0], [0, 0.35, 0], [0, 0, -1.0]], axis=1).astype(np.float32)
    return dens, np.array([0.5, 0.5, 2.2], np.float32), basis


def test_vpt_sharded_matches_jax():
    dens, ro, basis = _vpt_inputs()
    j = np.asarray(jmesh.render_vpt_sharded(
        jax.random.PRNGKey(5), jnp.asarray(dens), jnp.asarray(ro), jnp.asarray(basis), 32, 16,
        jmesh.make_device_mesh(2), settings=jvpt.VptSettings(max_events=4), spp=1))
    vs = tvpt.VptSettings(max_events=4)
    args = (torch.tensor(dens), torch.tensor(ro), torch.tensor(basis), 32, 16)
    t = _ranks(2, lambda g: pm.render_vpt_sharded(threefry.prng_key(5), *args, g, vs, spp=1))
    assert torch.equal(t[0], t[1])
    ranks = [tvpt.render_vpt(threefry.fold_in(threefry.prng_key(5), r), *args, vs, spp=1)
             for r in range(2)]
    assert torch.equal(t[0], vdiv(ranks[0] + ranks[1], 2))
    t = t[0].numpy()
    assert t.shape == j.shape == (16, 32, 3) and np.isfinite(t).all() and t.std() > 1e-3
    assert (np.abs(t - j) <= 1e-4).all(-1).mean() >= 0.95  # tests/test_torch_vpt.py:_agree
    assert abs(float(t.mean()) - float(j.mean())) <= 2e-3


def test_world_of_one_mesh_equals_single_device():
    """make_device_mesh(1) over a gloo world of one (an in-memory store):
    each sharded function equals the single-device one on the same draws."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        m = pm.make_device_mesh(1, device_type="cpu")
        with pytest.raises(ValueError):
            pm.make_device_mesh(2, device_type="cpu")
        with pytest.raises(RuntimeError):
            pm.make_device_mesh(1, device_type="cuda")  # a gloo world serves no card
        tm = _tiny_mesh()
        cam = Camera(position=(0.0, 0.3, 1.2), width=128, height=32)
        vp, cp, ab = ttr.camera_tensors(cam, "cpu")
        table = torch.tensor(TransferFunction.standard().table)
        S = RasterSettings(width=128, height=32, chunk=64)
        assert torch.equal(pm.render_opaque_sharded(tm, vp, cp, table, S, m),
                           render_opaque(tm, vp, cp, table, S))
        scene = ttr.build_capsule_scene(*entry._small_lines(), radius=0.02, device="cpu")
        so = RasterSettings(width=128, height=32, tile_w=16, tile_h=8, chunk=16, span_x=3,
                            span_y=3)
        assert torch.equal(pm.render_tubes_mlab_sharded(scene, vp, cp, ab, so, m, K=4),
                           render_tubes_mlab(scene, vp, cp, ab, so, K=4))
        rtao = trtao.RtaoSettings(num_samples=2, grid_resolution=16)
        folded = trtao.hemisphere_uniforms(threefry.fold_in(threefry.prng_key(0), 0),
                                           (2, 32, 128))
        assert torch.equal(pm.render_tubes_rtao_sharded(scene, vp, cp, ab, so, m, rtao=rtao),
                           trtao.render_tubes_rtao(scene, vp, cp, ab, so, rtao,
                                                   uniforms=folded))
        oo = too.OpacityOptimizationSettings(opacity_resolution_scale=1.0, gather_k=4)
        prev = torch.ones(8, 24)
        assert torch.equal(pm.opacity_solve_sharded(scene, vp, cp, ab, prev, so, oo, 8, 24, m),
                           too.opacity_solve(scene, vp, cp, ab, prev, so, oo, 8, 24))
        dens, ro, basis = _vpt_inputs()
        args = (torch.tensor(dens), torch.tensor(ro), torch.tensor(basis), 32, 16)
        vs = tvpt.VptSettings(max_events=4)
        assert torch.equal(pm.render_vpt_sharded(threefry.prng_key(5), *args, m, vs),
                           tvpt.render_vpt(threefry.fold_in(threefry.prng_key(5), 0), *args,
                                           vs, spp=1))
    finally:
        dist.destroy_process_group()


def test_sharded_calls_need_their_group():
    tm = _tiny_mesh()
    vp, cp, _ = ttr.camera_tensors(Camera(position=(0.0, 0.3, 1.2), width=128, height=40),
                                   "cpu")
    table = torch.tensor(TransferFunction.standard().table)
    S = RasterSettings(width=128, height=40, chunk=64)
    with pytest.raises(ValueError):
        pm.render_opaque_sharded(tm, vp, cp, table, S, None)
    with pytest.raises(TypeError):
        pm.render_opaque_sharded(tm, vp, cp, table, S, "y")  # a JAX axis name
    with pytest.raises(ValueError):  # 40 rows are not 2 bands of whole 8-row tiles
        _ranks(2, lambda g: pm.render_opaque_sharded(tm, vp, cp, table, S, g))
    with pytest.raises(ValueError):  # NCCL puts one rank on a card; this box has none
        pm.run_ranks(1, lambda g, d: None, "cuda")


def test_dryrun_multichip_on_cpu():
    shapes = entry.dryrun_multichip(2, device="cpu")
    assert shapes["opaque"] == (4, 32, 128) and shapes["vpt"] == (16, 32, 3)
    with pytest.raises(ValueError):
        entry.dryrun_multichip(1)  # the card by default: none here
