"""linevis_tpu_torch opacity optimization vs the JAX package on the CPU.

- The importance gather (B2 in store mode 'gather'): the port's plain
  version against the JAX kernel (Pallas interpret mode) on the PORT's
  binning and params, the rule of tests/test_torch_oit.py (the K-buffer
  follows run order). Node depths within 1e-6, segment ids equal on >=
  99.9% of valid nodes (where they differ, one side holds a tie window's
  i + 0.5), importance at B2's noise floor (2e-3 on 99.9% of nodes, 1e-4 on
  95%: ROADMAP queue C, the MLAB features' entry).
- The solve on identical nodes: JAX's own gather output fed to the port's
  `solve_vertex_opacity` equals JAX's `_opacity_solve` within 1e-6, at
  several settings.
- `use_bands` (diffuse exponent 1.0) per fragment and in the composite
  against the JAX kernel, at tests/test_torch_oit.py's bars.
- The band-sharded solve at n=2 (two gloo ranks) against JAX's
  `opacity_solve_sharded` on the same band nodes, within 1e-6.
- The behaviour of tests/test_opacity_optimization.py on the port, the
  golden `opacity_optimization.png` through the port's registry, and the
  entry point.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels import raster_capsule_oit as jk
from linevis_tpu.kernels.raster_pallas import SortedBinning as JSortedBinning
from linevis_tpu.render import opacity_optimization as joo
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import opacity_state_from_numpy, trajectories_from_numpy
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.entry import entry_opacity_optimization
from linevis_tpu_torch.kernels import raster_capsule_oit as tk
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import opacity_optimization as too
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.scene.line_data import LineData

from tests import golden_scenes

torch.set_num_threads(1)

W, H = 96, 64
TILE = (16, 8)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "opacity_optimization.png")


def _walk(radius=0.03, seed=12, L=10, P=8):
    # tests/golden_scenes.py:_walk_scene's inputs.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _settings(cls, w=W, h=H, **kw):
    # tests/golden_scenes.py:_settings
    return cls(width=w, height=h, tile_w=16, tile_h=8, chunk=32, span_x=3,
               span_y=3, depth_cue_strength=0.2, **kw)


def _camera(cls, w=W, h=H):
    return cls(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h)


def _port_frame(opacity=0.4):
    """The port's MLAB frame prep of the walk scene -> (csr, params, settings)."""
    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    S = _settings(RasterSettings)
    csr, params = toit.prepare_mlab_frame(
        ts, *ttr.camera_tensors(_camera(Camera), "cpu"), S, opacity)
    return csr, params, S


def _jax_csr(csr):
    return JSortedBinning(
        jnp.asarray(csr.payload.numpy()), jnp.asarray(csr.tile_start.numpy()),
        jnp.asarray(csr.tile_count.numpy()), csr.tiles_x, csr.tiles_y, csr.chunk,
    )


def _jax_kernel(csr, params, S, K, **kw):
    """The JAX kernel (interpret mode) on the port's binning and params."""
    out = jk.rasterize_capsules_mlab(
        _jax_csr(csr), jnp.asarray(params.numpy()), W, H, *TILE, K=K, tf_color=S.tf_color,
        tf_opacity=S.tf_opacity, interpret=True, **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port_kernel(csr, params, S, K, **kw):
    launches = tk.rasterize_capsules_mlab.launches
    out = tk.rasterize_capsules_mlab(csr, params, W, H, *TILE, K, S.tf_color, S.tf_opacity,
                                     **kw)
    assert tk.rasterize_capsules_mlab.launches == launches  # CPU: plain version
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _check_spread(err):
    assert (err <= 2e-3).mean() >= 0.999, err.max()
    assert (err <= 1e-4).mean() >= 0.95, (err <= 1e-4).mean()


@pytest.mark.parametrize("K", [4, 8])
def test_gather_matches_jax(K):
    csr, params, S = _port_frame()
    jd, jv, ja = _jax_kernel(csr, params, S, K, store_mode="gather")
    td, tv, ta = _port_kernel(csr, params, S, K, store_mode="gather")
    valid = td < 1.5
    assert valid.sum() > 1000  # the scene is on screen
    assert np.array_equal(valid, jd < 1.5)
    assert np.abs(jd - td).max() <= 1e-6
    # Alpha 1 on every node (not premultiplied), 0 on empty ones; plane b 0.
    np.testing.assert_array_equal(ta, np.where(valid, 1.0, 0.0))
    np.testing.assert_array_equal(ta, ja)
    assert not tv[2].any() and not jv[2].any()
    # Segment ids: equal, except inside a tie window (a half-integer on one
    # side: a joint's cap and the next segment's body averaged).
    tid, jid = tv[1][valid], jv[1][valid]
    same = tid == jid
    assert same.mean() >= 0.999
    assert ((tid[~same] % 1 == 0.5) | (jid[~same] % 1 == 0.5)).all()
    assert (tid == np.round(tid)).mean() > 0.99
    assert tid.max() < 10 * 7  # ids of the walk scene's segments
    _check_spread(np.abs(jv[0] - tv[0])[valid])


def test_gather_takes_the_front_k_nodes_in_order():
    """Every alpha is 1: the MLAB merge adds nothing, so the gather holds the
    K nearest fragments of each pixel, and an empty node follows no full one."""
    csr, params, S = _port_frame()
    d4, v4, _ = _port_kernel(csr, params, S, 4, store_mode="gather")
    d8, v8, _ = _port_kernel(csr, params, S, 8, store_mode="gather")
    assert (np.diff(d8, axis=0) >= 0).all()
    np.testing.assert_array_equal(d8[:4], d4)
    np.testing.assert_array_equal(v8[:, :4], v4)
    assert (d8[4:] < 1.5).any()  # some pixel has more than 4 nodes


# The solve on JAX's own gather nodes.

SOLVE_SIZE = (128, 96)  # the half-res gather is 64 x 48


def _solve_inputs():
    """JAX's walk scene (tests/golden_scenes.py `_line_data(seed=33)`), camera,
    settings and a previous frame's opacities from a numpy seed."""
    ld = golden_scenes._line_data(seed=33)
    traj = ld.trajectories
    scene = ld.get_capsule_scene()
    w, h = SOLVE_SIZE
    cam = _camera(JCamera, w, h)
    S = JSettings(width=w, height=h, tile_w=16, tile_h=8)
    prev = np.random.default_rng(4).uniform(0.2, 1.0, traj.positions.shape[:2]).astype(
        np.float32)
    args = (jnp.asarray(cam.view_projection_matrix()),
            jnp.asarray(np.asarray(cam.position, np.float32)),
            jnp.asarray(jtr._proj_constants(cam)))
    return scene, traj, S, args, prev


def _jax_gather(scene, S, args, oo):
    """`_opacity_solve`'s gather: the half-res frame prep and the JAX kernel in
    store mode 'gather' with its arguments."""
    half = too.gather_settings(RasterSettings(width=S.width, height=S.height), oo)
    s2 = dataclasses.replace(S, width=half.width, height=half.height)
    csr, params, _ = jtr.prepare_capsule_frame(scene, *args, s2)
    return jk.rasterize_capsules_mlab(
        csr, params, s2.width, s2.height, s2.tile_w, s2.tile_h, oo.gather_k,
        S.tf_color, S.tf_opacity, store_mode="gather", interpret=True)


SOLVE_CASES = [
    joo.OpacityOptimizationSettings(),
    joo.OpacityOptimizationSettings(s=0),
    joo.OpacityOptimizationSettings(temporal_smoothing=1.0),
    joo.OpacityOptimizationSettings(s=0, temporal_smoothing=1.0, q=50.0, r=5.0),
    joo.OpacityOptimizationSettings(lambda_=0.5, relaxation=0.4, s=6),
]


def test_solve_on_jax_nodes_matches_jax(monkeypatch):
    scene, traj, S, args, prev = _solve_inputs()
    L, P = traj.positions.shape[:2]
    oo0 = SOLVE_CASES[0]
    depths, vals, _ = (np.asarray(x) for x in _jax_gather(scene, S, args, oo0))
    valid = depths < 1.5
    assert valid.sum() > 500 and (valid.sum(0) == oo0.gather_k).any()

    def port(oo):
        t = too.OpacityOptimizationSettings(**dataclasses.asdict(oo))
        return too.solve_vertex_opacity(
            torch.tensor(depths), torch.tensor(vals[0]), torch.tensor(vals[1]),
            torch.tensor(prev), t, L, P, scene.num_segments).numpy()

    # JAX's `_opacity_solve` runs with its gather call handing back the
    # gather output above (the gather does not depend on the solve's
    # settings), so each setting compiles the solve alone.
    monkeypatch.setattr(joo, "rasterize_capsules_mlab", lambda *a, **k: (
        jnp.asarray(depths), jnp.asarray(vals), jnp.ones_like(jnp.asarray(depths))))
    solved = []
    for oo in SOLVE_CASES:
        j = np.asarray(joo._opacity_solve(scene, *args, jnp.asarray(prev), S, oo, L, P))
        np.testing.assert_allclose(port(oo), j, rtol=0, atol=1e-6, err_msg=str(oo))
        solved.append(j)
    assert solved[0].min() < 0.5 < solved[0].max()  # some vertices fade, not all
    assert min(np.abs(a - b).max() for a, b in zip(solved, solved[1:])) > 1e-3


def test_ids_of_a_tie_window_truncate():
    """A node averaging segments i and i+1 (id i + 0.5) counts for segment i,
    as the JAX package's .astype(int32) truncates; other segments keep 1."""
    oo = too.OpacityOptimizationSettings(s=0, temporal_smoothing=1.0)
    depths = torch.tensor([0.5, 0.6, 2.0])[:, None, None]
    g = torch.tensor([0.2, 0.9, 0.0])[:, None, None]
    sid = torch.tensor([2.5, 4.0, 0.0])[:, None, None]
    vo = too.solve_vertex_opacity(depths, g, sid, torch.ones(1, 7), oo, 1, 7, 6)
    a0 = 1.0 / (1.0 + 0.8 ** 4 * 2000.0 * 0.81)  # g_b: node 1's 0.9^2 behind it
    a1 = 1.0 / (1.0 + 0.1 ** 4 * 20.0 * 0.04)  # g_f: node 0's 0.2^2 in front
    want = [1, 1, (1 + a0) / 2, (a0 + 1) / 2, (1 + a1) / 2, (a1 + 1) / 2, 1]
    np.testing.assert_allclose(vo[0].numpy(), want, rtol=1e-6)


# use_bands against the JAX kernel.

def test_use_bands_per_fragment_matches_jax():
    csr, params, S = _port_frame()
    kw = dict(use_bands=True, no_overflow=True)
    jd, jc, ja = _jax_kernel(csr, params, S, 8, **kw)
    td, tc, ta = _port_kernel(csr, params, S, 8, **kw)
    _, tc17, _ = _port_kernel(csr, params, S, 8, no_overflow=True)
    assert (td < 2.0).sum() > 300
    assert (np.abs(jd - td).max(axis=0) <= 1e-6).mean() >= 0.999
    assert (np.abs(ja - ta).max(axis=0) <= 1e-5).mean() >= 0.999
    _check_spread(np.abs(jc - tc).max(axis=(0, 1)))
    assert np.abs(tc - tc17).max() > 1e-2  # the exponent matters


def test_use_bands_composite_matches_jax_and_shade_nodes():
    csr, params, S = _port_frame()
    kw = dict(use_bands=True, deferred_shade=True, composite=True)
    j = _jax_kernel(csr, params, S, 8, **kw)
    t = _port_kernel(csr, params, S, 8, **kw)
    assert (t[3] > 0).sum() > 300
    _check_spread(np.abs(j - t).max(axis=0))
    # The composite is shade_deferred_nodes(use_bands=True) blended front to back.
    d, f, a = (torch.tensor(x) for x in _port_kernel(csr, params, S, 8, deferred_shade=True))
    rgb = toit.shade_deferred_nodes(d, f, a, params[9:11], params[11], params[12],
                                    params[13], S, use_bands=True)
    resolved = tk.blend_front_to_back(rgb, a, params[24:27]).numpy()
    np.testing.assert_allclose(resolved, t, rtol=0, atol=1e-6)


# Behaviour mirrored from tests/test_opacity_optimization.py, on the port.

OW, OH = 32, 16


def _occluder_lines():
    """A high-importance line in front of four low-importance lines ->
    (positions [5, 2, 3], mask, attrs)."""
    n_back = 4
    pos = np.zeros((n_back + 1, 2, 3), np.float32)
    attrs = np.full((n_back + 1, 2), 0.1, np.float32)  # unimportant
    for i in range(n_back):
        pos[i, 0] = (-0.4, -0.15 + 0.08 * i, 0.0)
        pos[i, 1] = (0.4, -0.15 + 0.08 * i, 0.0)
    pos[n_back, 0] = (-0.4, 0.0, 0.3)  # in front
    pos[n_back, 1] = (0.4, 0.0, 0.3)
    attrs[n_back] = 0.95  # important
    return pos, np.ones((n_back + 1, 2), bool), attrs


def _scene_occluder():
    return ttr.build_capsule_scene(*_occluder_lines(), radius=0.05, device="cpu"), 5, 2


def _occluder_settings():
    return RasterSettings(width=OW, height=OH, tile_w=16, tile_h=8, chunk=8, span_x=3,
                          span_y=3)


def test_unimportant_occluders_fade():
    scene, L, P = _scene_occluder()
    cam = Camera(position=(0.0, 0.0, 1.6), width=OW, height=OH)
    oo = too.OpacityOptimizationSettings(s=4, gather_k=4, render_k=4,
                                         opacity_resolution_scale=1.0,
                                         temporal_smoothing=0.5)
    r = too.OpacityOptimizationRenderer(scene, L, P, _occluder_settings(), oo)
    for _ in range(3):
        img = r.render(cam)
    vo = r.vertex_opacity.numpy()
    assert vo[L - 1].mean() > 0.5, vo[L - 1]
    assert vo[: L - 1].mean() < vo[L - 1].mean()
    img = np.moveaxis(img.numpy(), 0, -1)
    assert np.isfinite(img).all() and img.shape == (OH, OW, 4)


def test_opacity_solve_formula():
    """q = r = 0: no energy term, every fragment opaque."""
    scene, L, P = _scene_occluder()
    cam = Camera(position=(0.0, 0.0, 1.6), width=OW, height=OH)
    oo = too.OpacityOptimizationSettings(q=0.0, r=0.0, s=0, gather_k=4, render_k=4,
                                         opacity_resolution_scale=1.0,
                                         temporal_smoothing=1.0)
    r = too.OpacityOptimizationRenderer(scene, L, P, _occluder_settings(), oo)
    r.render(cam)
    assert (r.vertex_opacity.numpy() > 0.99).all()


def test_post_move_smoothing_schedule():
    """40 extra solve frames after a camera move; a static camera converges
    and then freezes (OpacityOptimizationRenderer.hpp:125-127)."""
    scene, L, P = _scene_occluder()
    cam = Camera(position=(0.0, 0.0, 1.6), width=OW, height=OH)
    oo = too.OpacityOptimizationSettings(s=2, gather_k=4, render_k=4,
                                         opacity_resolution_scale=1.0)
    r = too.OpacityOptimizationRenderer(scene, L, P, _occluder_settings(), oo)
    assert r.smoothing_frames_remaining == 40
    r.render(cam)
    assert r.smoothing_frames_remaining == 39
    r.render(cam)
    assert r.smoothing_frames_remaining == 38
    cam2 = dataclasses.replace(cam, position=(0.1, 0.1, 1.3))
    r.render(cam2)
    assert r.smoothing_frames_remaining == 39
    r.smoothing_frames_remaining = 0
    op0 = r.vertex_opacity.clone()
    r.render(cam2)
    assert torch.equal(r.vertex_opacity, op0)


def test_band_axis_raises():
    """`band_axis` takes a process group or a 1-D DeviceMesh: a JAX axis
    name, or anything else, raises; the band count is the group's size, so
    the solve takes no `n_bands`."""
    from linevis_tpu_torch.parallel.mesh import run_ranks

    pos, mask, attrs, radius = _walk()
    L, P = pos.shape[:2]
    ts = ttr.build_capsule_scene(pos, mask, attrs, radius, device="cpu")
    oo = too.OpacityOptimizationSettings(opacity_resolution_scale=1.0, gather_k=4)
    S = _settings(RasterSettings)
    cam = ttr.camera_tensors(_camera(Camera), "cpu")
    prev = torch.ones((L, P))
    for axis in ("y", 2):
        with pytest.raises(TypeError):
            too.opacity_solve(ts, *cam, prev, S, oo, L, P, band_axis=axis)
    with pytest.raises(TypeError):
        run_ranks(2, lambda g, d: too.opacity_solve(ts, *cam, prev, S, oo, L, P, band_axis=g,
                                                    n_bands=2))


def test_band_solve_on_two_ranks_matches_jax(monkeypatch):
    """The band-sharded solve (`band_axis`, a process group) on two gloo
    ranks (threads, `parallel/mesh.py:run_ranks`): each rank gathers its
    half of the half-res frame and the per-segment minimum and visibility
    are reduced over both. Held against JAX's `opacity_solve_sharded` at
    n=2 on the conftest's virtual devices, whose gather hands back each
    band's port nodes (the gather is held against the JAX kernel above; so
    the JAX side compiles the band prep and the solve alone), within 1e-6
    as `test_solve_on_jax_nodes_matches_jax`; and against the port's
    single-device solve at tests/test_multichip.py:224-227's bars."""
    import jax

    from linevis_tpu.parallel import mesh as jmesh
    from linevis_tpu_torch.parallel.mesh import run_ranks

    pos, mask, attrs, radius = _walk()
    L, P = pos.shape[:2]
    js = jtr.build_capsule_scene(pos, mask, attrs, radius)
    ts = ttr.build_capsule_scene(pos, mask, attrs, radius, device="cpu")
    kw = dict(opacity_resolution_scale=1.0, gather_k=4)  # a 96x64 gather: 2 bands of 32 rows
    oo = too.OpacityOptimizationSettings(**kw)
    S, jS = _settings(RasterSettings), _settings(JSettings)
    cam = ttr.camera_tensors(_camera(Camera), "cpu")
    jcam = _camera(JCamera)
    prev = np.random.default_rng(4).uniform(0.2, 1.0, (L, P)).astype(np.float32)
    solved = run_ranks(2, lambda g, d: too.opacity_solve(
        ts, *cam, torch.tensor(prev), S, oo, L, P, band_axis=g))
    assert torch.equal(solved[0], solved[1])
    nodes = [too.gather_importance(ts, *cam, S, oo, band=b, n_bands=2) for b in range(2)]
    assert all(int((n_[0] < 1.5).sum()) > 50 for n_ in nodes)  # both bands hold fragments
    depths, g, sid = (jnp.asarray(np.stack([n_[i].numpy() for n_ in nodes])) for i in range(3))

    def band_nodes(*a, **k):  # the gather of band axis_index
        b = jax.lax.axis_index("y")
        return depths[b], jnp.stack([g[b], sid[b], jnp.zeros_like(g[b])]), jnp.ones_like(g[b])

    monkeypatch.setattr(joo, "rasterize_capsules_mlab", band_nodes)
    j = np.asarray(jmesh.opacity_solve_sharded(
        js, jnp.asarray(jcam.view_projection_matrix()),
        jnp.asarray(np.asarray(jcam.position, np.float32)),
        jnp.asarray(jtr._proj_constants(jcam)), jnp.asarray(prev), jS,
        joo.OpacityOptimizationSettings(**kw), L, P, jmesh.make_device_mesh(2)))
    np.testing.assert_allclose(solved[0].numpy(), j, rtol=0, atol=1e-6)
    single = too.opacity_solve(ts, *cam, torch.tensor(prev), S, oo, L, P).numpy()
    diff = np.abs(solved[0].numpy() - single)
    assert (diff > 1e-3).mean() < 0.05 and np.median(diff) < 1e-6
    assert np.abs(single - prev).max() > 1e-2  # the solve moved the opacities


def test_renderer_continues_a_jax_run():
    """The JAX renderer's state carried over: the port's next frame matches
    JAX's next frame (each package with its own frame prep and gather)."""
    js, L, P = jtr.build_capsule_scene(*_occluder_lines(), radius=0.05), 5, 2
    S = JSettings(width=OW, height=OH, tile_w=16, tile_h=8, chunk=8, span_x=3, span_y=3)
    oo = joo.OpacityOptimizationSettings(s=4, gather_k=4, render_k=4,
                                         opacity_resolution_scale=1.0)
    cam = JCamera(position=(0.0, 0.0, 1.6), width=OW, height=OH)
    jr = joo.OpacityOptimizationRenderer(js, L, P, S, oo)
    jr.render(cam)
    state = dict(vertex_opacity=np.asarray(jr.vertex_opacity),
                 smoothing_frames_remaining=jr.smoothing_frames_remaining,
                 last_vp=jr._last_vp)
    scene, _, _ = _scene_occluder()
    tr = too.OpacityOptimizationRenderer(
        scene, L, P, _occluder_settings(),
        too.OpacityOptimizationSettings(**dataclasses.asdict(oo)))
    opacity_state_from_numpy(tr, state)
    assert tr.smoothing_frames_remaining == 39
    tcam = Camera(position=(0.0, 0.0, 1.6), width=OW, height=OH)
    j_img = np.asarray(jr.render(cam))
    t_img = tr.render(tcam).numpy()
    assert tr.smoothing_frames_remaining == jr.smoothing_frames_remaining == 38
    np.testing.assert_allclose(tr.vertex_opacity.numpy(), np.asarray(jr.vertex_opacity),
                               rtol=0, atol=1e-5)
    assert np.abs(t_img - j_img).mean() <= 2e-3


def _port_line_data(seed):
    """tests/golden_scenes.py `_line_data(seed)` as the port's LineData."""
    jld = golden_scenes._line_data(seed=seed)
    t = jld.trajectories
    ld = LineData(trajectories_from_numpy(dict(
        positions=t.positions, attributes=t.attributes, mask=t.mask, num_points=t.num_points,
        attribute_names=t.attribute_names)))
    ld.set_line_width(jld.line_width)
    return ld


def test_golden_through_the_port_registry():
    """tests/golden_scenes.py scene_opacity_optimization: one frame of the
    registry's mode on `_line_data(seed=33)` at 64x48."""
    w, h = golden_scenes.SMALL_SIZE
    r = create_renderer("Opacity Optimization", SettingsMap({}), device="cpu")
    r.set_line_data(_port_line_data(33))
    img = r.render(_camera(Camera, w, h))
    assert img.shape == (h, w, 4) and np.isfinite(img).all()
    assert (img[..., 3] > 0).mean() > 0.05
    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_entry_opacity_optimization_runs_on_cpu_and_defaults_to_cuda():
    fn, args = entry_opacity_optimization(device="cpu")
    img = fn(*args)
    assert img.shape == (4, 128, 256) and bool(torch.isfinite(img).all())
    assert bool((img[3] > 0).any()) and bool((img[:3] < 0.999).any())
    assert fn.__self__.smoothing_frames_remaining == 39
    if torch.cuda.is_available():
        fn, _ = entry_opacity_optimization()
        assert fn.__self__.scene.a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            entry_opacity_optimization()
