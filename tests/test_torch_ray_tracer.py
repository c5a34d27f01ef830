"""linevis_tpu_torch ray-traced transparency (re-cast loop, MLAT) vs the JAX package on the CPU.

Both packages traverse the SAME tree: JAX's `build_capsule_bvh` / `build_lbvh`
output carried across with `convert.lbvh_from_numpy`. Bars, each stated where
it is checked:
- `ray_query` in AABB mode: t and prim identical to JAX's (the slab test is
  the same float32 subtract, multiply, min and max on both sides);
- a custom primitive function: prims equal and t within 1e-5 relative (the
  sphere test's dot products, contracted by XLA:CPU: 3.2e-6 measured);
- the capsule enumeration: prims equal on >= 99.5% of the live rays of each
  cast and t within 1e-4 relative on the rays with equal prims. The hit t
  turns on the capsule quadratic's cancellation (oa.oa - r^2 formed from
  terms a thousand times larger, ROADMAP queue C), which XLA:CPU evaluates
  with contracted multiply-adds and the port with each operation rounded
  alone: measured 3.5e-5 relative at most, and a near-tie of two surfaces
  can order the other way;
- whole images at SSIM >= 0.999 and mean abs <= 2e-3, and every RGBA
  channel within 2e-3 on >= 99.9% of pixels: the noise floor ROADMAP queue C
  documents for B2 and B6 (the shading features come from the same scalar
  identities; the port takes 1/sqrt where JAX takes `lax.rsqrt`, which is
  not correctly rounded on XLA:CPU). The JAX renderers keep their features
  inside, so they are held through the image;
- the behaviour of tests/test_ray_tracer.py on the port, at its bars.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.ops import lbvh as jlbvh
from linevis_tpu.render import ray_tracer as jrt
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import capsule_scene_from_numpy, lbvh_from_numpy
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.kernels import bvh_closest_hit as tch
from linevis_tpu_torch.ops import lbvh as tlbvh
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import ray_tracer as trt
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.scene.line_data import LineData

torch.set_num_threads(1)

W, H = 64, 48
TREE_FIELDS = ("left", "right", "node_min", "node_max", "leaf_prim")


def _carry(jtree):
    return lbvh_from_numpy({f: np.asarray(getattr(jtree, f)) for f in TREE_FIELDS})


def _walk(radius=0.03, seed=12, L=5, P=8):
    # tests/test_ray_tracer.py:_scene's inputs.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _scenes(lines=None, **kw):
    pos, mask, attrs, radius = lines or _walk(**kw)
    js = jtr.build_capsule_scene(pos, mask, attrs, radius=radius)
    ts = capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}, "cpu")
    return js, ts


def _args(w=W, h=H):
    # tests/test_ray_tracer.py:_args
    cam = JCamera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h)
    kw = dict(width=w, height=h, tile_w=16, tile_h=8, chunk=32, span_x=3, span_y=3)
    jargs = (jnp.asarray(cam.view_projection_matrix()),
             jnp.asarray(np.asarray(cam.position, np.float32)),
             jnp.asarray(jtr._proj_constants(cam)), JSettings(**kw))
    tcam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h)
    return jargs, (*ttr.camera_tensors(tcam, "cpu"), RasterSettings(**kw))


def _images_agree(t_img, j_img):
    t_img, j_img = np.asarray(t_img), np.asarray(j_img)
    assert t_img.shape == j_img.shape and np.isfinite(t_img).all()
    assert ssim(np.moveaxis(t_img[:3], 0, -1), np.moveaxis(j_img[:3], 0, -1)) >= 0.999
    diff = np.abs(t_img - j_img)
    assert diff.mean() <= 2e-3
    assert (diff.max(axis=0) <= 2e-3).mean() >= 0.999


def _boxes(n, seed):
    # tests/test_lbvh.py:_boxes
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.1, (n, 3)).astype(np.float32)
    return c - h, c + h


def _query_rays(R, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, -2, (R, 3)).astype(np.float32)
    d = rng.uniform(0.2, 1, (R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_ray_query_matches_jax_and_brute_force():
    """tests/test_lbvh.py::test_ray_query_matches_brute_force on JAX's tree:
    the port's t and prim identical to JAX's, t within 1e-4 of the brute
    force."""
    amin, amax = _boxes(300, seed=2)
    jtree = jlbvh.build_lbvh(jnp.asarray(amin), jnp.asarray(amax))
    o, d = _query_rays(128, seed=3)
    jt, jp = (np.asarray(x) for x in jlbvh.ray_query(jtree, jnp.asarray(o), jnp.asarray(d)))
    stats = torch.zeros((128, 2), dtype=torch.int64)
    tt, tp = tlbvh.ray_query(_carry(jtree), torch.as_tensor(o), torch.as_tensor(d), stats=stats)
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tp.numpy(), jp)
    inv = 1.0 / d
    hits = 0
    for r in range(128):
        t0, t1 = (amin - o[r]) * inv[r], (amax - o[r]) * inv[r]
        tn, tf = np.minimum(t0, t1).max(-1), np.maximum(t0, t1).min(-1)
        bt = np.where(tf >= np.maximum(tn, 0), np.maximum(tn, 0), np.inf).min()
        if np.isfinite(bt):
            hits += 1
            assert abs(tt[r].item() - bt) < 1e-4
        else:
            assert tp[r].item() == -1
    assert hits > 10
    # Every ray visits the root; leaf tests only where a leaf box is hit.
    assert (stats[:, 0] >= 1).all() and (stats[:, 1] <= stats[:, 0]).all()


def test_ray_query_custom_primitive_fn():
    """tests/test_lbvh.py::test_ray_query_custom_primitive_fn: analytic
    spheres at the leaves, batched; prims equal to JAX's and the brute
    force's, t within 1e-6 relative of JAX's. Its random rays hit no sphere,
    so half of the rays here aim at a sphere's center."""
    rng = np.random.default_rng(5)
    n = 64
    c = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.08, (n,)).astype(np.float32)
    jtree = jlbvh.build_lbvh(jnp.asarray(c - r[:, None]), jnp.asarray(c + r[:, None]))
    cj, rj = jnp.asarray(c), jnp.asarray(r)

    def jsphere(prim, o, d):
        oc = o - cj[prim]
        b = jnp.dot(oc, d)
        disc = b * b - (jnp.dot(oc, oc) - rj[prim] ** 2)
        t = -b - jnp.sqrt(jnp.maximum(disc, 0.0))
        return jnp.where((disc >= 0) & (t > 0), t, jnp.inf)

    ct, rt = torch.as_tensor(c), torch.as_tensor(r)

    def tsphere(prim, o, d):
        oc = o - ct[prim]
        b = torch.sum(oc * d, dim=1)
        disc = b * b - (torch.sum(oc * oc, dim=1) - rt[prim] ** 2)
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        return torch.where((disc >= 0) & (t > 0), t, float("inf"))

    o = rng.uniform(-3, -2, (64, 3)).astype(np.float32)
    d = rng.uniform(0.2, 1, (64, 3)).astype(np.float32)
    d[:32] = c[:32] - o[:32]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jt, jp = (np.asarray(x) for x in jlbvh.ray_query(jtree, jnp.asarray(o), jnp.asarray(d),
                                                     prim_hit_fn=jsphere))
    tt, tp = tlbvh.ray_query(_carry(jtree), torch.as_tensor(o), torch.as_tensor(d),
                             prim_hit_fn=tsphere)
    np.testing.assert_array_equal(tp.numpy(), jp)
    hit = jp >= 0
    assert hit.sum() >= 32
    np.testing.assert_allclose(tt.numpy()[hit], jt[hit], rtol=1e-5)
    for q in range(64):
        oc = o[q][None] - c
        b = (oc * d[q][None]).sum(-1)
        disc = b * b - ((oc * oc).sum(-1) - r ** 2)
        ts = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        ts = np.where(ts > 0, ts, np.inf)
        assert tp[q].item() == (ts.argmin() if np.isfinite(ts.min()) else -1)


def test_capsule_enumeration_matches_jax():
    """The re-cast loop's query: from the camera, eight enumerate-mode casts
    through the capsule leaf function, each starting strictly after the
    last (t, prim) that its own package returned (JAX's `ray_query` +
    `_make_capsule_hit`; the port's plain kernel version): the same sequence
    of surfaces."""
    js, ts = _scenes()
    jbvh = jrt.build_capsule_bvh(js)
    tree = _carry(jbvh)
    _, (vp, cp, ab, S) = _args()
    o, d, _, pad = trt.tile_rays(vp, cp, S)
    R = o.shape[0]
    j_hit = jrt._make_capsule_hit(js)
    big = np.iinfo(np.int32).max
    jt_min, jp_min = jnp.zeros(R, jnp.float32), jnp.full(R, big, jnp.int32)
    tt_min, tp_min = torch.zeros(R), torch.full((R,), big, dtype=torch.int32)
    live = ~pad.numpy()
    done = pad.clone()
    n_hits = 0
    for _ in range(8):
        jt, jp = jlbvh.ray_query(jbvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                 prim_hit_fn=j_hit, t_min=jt_min, prim_min=jp_min)
        tt, tp = tch.capsule_closest_hit(tree, ts, o, d, tt_min, tp_min, done)
        jt_np, jp_np, tt_np, tp_np = (np.asarray(x) for x in (jt, jp, tt, tp))
        assert (tp_np[pad.numpy()] == -1).all() and np.isinf(tt_np[pad.numpy()]).all()
        same = tp_np == jp_np
        assert same[live].mean() >= 0.995
        hit = live & same & (jp_np >= 0)
        np.testing.assert_allclose(tt_np[hit], jt_np[hit], rtol=1e-4)
        n_hits += int(hit.sum())
        jt_min = jnp.where(jp >= 0, jt, jt_min)
        jp_min = jnp.where(jp >= 0, jp, jp_min)
        t_hit = tp >= 0
        tt_min = torch.where(t_hit, tt, tt_min)
        tp_min = torch.where(t_hit, tp, tp_min)
    assert n_hits > 500


def test_ray_query_stack_overflow_raises():
    """A push past max_stack raises (the JAX function writes it to the last
    slot unchecked: a deliberate difference, ROADMAP queue C)."""
    amin, amax = _boxes(300, seed=2)
    tree = tlbvh.build_lbvh(torch.as_tensor(amin), torch.as_tensor(amax))
    o, d = _query_rays(128, seed=3)
    tlbvh.ray_query(tree, torch.as_tensor(o), torch.as_tensor(d), max_stack=64)
    with pytest.raises(tlbvh.StackOverflowError):
        tlbvh.ray_query(tree, torch.as_tensor(o), torch.as_tensor(d), max_stack=3)


@pytest.mark.parametrize("renderer", ["raytraced", "mlat"])
def test_render_matches_jax(renderer):
    """tests/test_ray_tracer.py's walk scene and camera at 64x48 on JAX's
    tree: re-cast (24 casts) and MLAT (K=8), opacity 0.4, depth cue 0.3."""
    js, ts = _scenes()
    jbvh = jrt.build_capsule_bvh(js)
    jargs, targs = _args()
    jargs = jargs[:3] + (dataclasses.replace(jargs[3], depth_cue_strength=0.3),)
    targs = targs[:3] + (dataclasses.replace(targs[3], depth_cue_strength=0.3),)
    if renderer == "raytraced":
        kw = dict(max_depth_complexity=24, opacity=0.4)
        j_img = jrt.render_tubes_raytraced(js, *jargs, bvh=jbvh, **kw)
        t_img = trt.render_tubes_raytraced(ts, *targs, bvh=_carry(jbvh), **kw)
    else:
        kw = dict(K=8, opacity=0.4)
        j_img = jrt.render_tubes_mlat(js, *jargs, bvh=jbvh, **kw)
        t_img = trt.render_tubes_mlat(ts, *targs, bvh=_carry(jbvh), **kw)
    assert (t_img[3] > 0.05).float().mean().item() > 0.05
    _images_agree(t_img.numpy(), j_img)


def test_jitter_matches_jax():
    js, ts = _scenes()
    jbvh = jrt.build_capsule_bvh(js)
    jargs, targs = _args()
    jit = np.array([0.25, -0.3], np.float32)
    j_img = jrt.render_tubes_raytraced(js, *jargs, max_depth_complexity=8, opacity=0.4,
                                       bvh=jbvh, jitter=jnp.asarray(jit))
    t_img = trt.render_tubes_raytraced(ts, *targs, max_depth_complexity=8, opacity=0.4,
                                       bvh=_carry(jbvh), jitter=torch.as_tensor(jit))
    _images_agree(t_img.numpy(), j_img)


# tests/test_ray_tracer.py's behaviour on the port.

def test_raytraced_matches_mlab_exact_blend():
    """Depth complexity <= K: the re-cast loop and the two-sided MLAB
    K-buffer are both exact front-to-back blends of the same surfaces (the
    JAX test's bars)."""
    _, ts = _scenes()
    _, targs = _args()
    rt = trt.render_tubes_raytraced(ts, *targs, max_depth_complexity=24, opacity=0.4).numpy()
    ml = toit.render_tubes_mlab(ts, *targs, K=16, opacity=0.4, two_sided=True).numpy()
    diff = np.abs(rt - ml)
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 0.05).mean() < 0.01


def test_raytraced_transmittance_saturates():
    _, ts = _scenes(radius=0.05)
    _, targs = _args()
    img = trt.render_tubes_raytraced(ts, *targs, max_depth_complexity=4, opacity=1.0).numpy()
    assert np.isfinite(img).all()
    a = img[3]
    assert ((a > 0.99) | (a < 0.01)).mean() > 0.95


def test_mlat_matches_recast_on_disjoint_segments():
    """MLAT == the exact re-cast loop where the depth complexity is at most
    K and no coincident joint surfaces exist (disjoint single-segment
    lines)."""
    L = 6
    pos = np.zeros((L, 2, 3), np.float32)
    for i in range(L):
        pos[i, 0] = (-0.3, -0.2 + 0.08 * i, -0.1 + 0.03 * i)
        pos[i, 1] = (0.3, -0.2 + 0.08 * i, 0.1 - 0.03 * i)
    attrs = np.linspace(0, 1, 2 * L, dtype=np.float32).reshape(L, 2)
    _, ts = _scenes(lines=(pos, np.ones((L, 2), bool), attrs, 0.04))
    _, targs = _args()
    rt = trt.render_tubes_raytraced(ts, *targs, max_depth_complexity=16, opacity=0.5).numpy()
    ml = trt.render_tubes_mlat(ts, *targs, K=8, opacity=0.5).numpy()
    assert np.isfinite(ml).all()
    diff = np.abs(rt - ml)
    assert diff.mean() < 1e-4, diff.mean()
    assert diff.max() < 1e-2, diff.max()


@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_bvh_reuse_is_identical(builder):
    _, ts = _scenes()
    _, targs = _args()
    kw = dict(max_depth_complexity=8, opacity=0.4)
    bvh = trt.build_capsule_bvh(ts, builder=builder)
    a = trt.render_tubes_raytraced(ts, *targs, bvh=bvh, **kw)
    b = trt.render_tubes_raytraced(ts, *targs, bvh=bvh, **kw)
    assert torch.equal(a, b)
    if builder == "linear":
        assert torch.equal(a, trt.render_tubes_raytraced(ts, *targs, **kw))


def _line_data(seed=7, L=3, P=4):
    # tests/test_ray_tracer.py::test_registry_vulkan_ray_tracer_mode's lines.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.08, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    traj = Trajectories(positions=pos, attributes=rng.uniform(0, 1, (L, 1, P)).astype(np.float32),
                        mask=np.ones((L, P), bool), num_points=np.full((L,), P, np.int32),
                        attribute_names=["a"])
    ld = LineData(traj)
    ld.set_line_width(0.06)
    return ld


def test_registry_vulkan_ray_tracer_mode():
    """The mode by name: frame 0 is `render_tubes_raytraced` unjittered,
    frame 1 the mean with a Halton(2, 3)-jittered frame, a camera move
    restarts the accumulation; `use_mlat` switches to MLAT with `num_nodes`
    nodes."""
    ld = _line_data()
    r = trenderer.create_renderer("Vulkan Ray Tracer", device="cpu")
    assert type(r).__name__ == "VulkanRayTracerRenderer" and r.device.type == "cpu"
    r.set_line_data(ld)
    cam = Camera(position=(0.0, 0.1, 1.2), width=32, height=16)
    scene = ld.get_capsule_scene(device="cpu")
    args = (*ttr.camera_tensors(cam, "cpu"), r._raster_settings(cam))
    f0 = trt.render_tubes_raytraced(scene, *args, opacity=r.opacity)
    a = r.render(cam)
    assert r._frame == 1
    np.testing.assert_array_equal(a, np.moveaxis(f0.numpy(), 0, -1))
    b = r.render(cam)
    assert r._frame == 2 and np.isfinite(b).all()
    jit = torch.tensor([trenderer._halton(1, 2) - 0.5, trenderer._halton(1, 3) - 0.5])
    f1 = trt.render_tubes_raytraced(scene, *args, opacity=r.opacity, jitter=jit)
    assert not torch.equal(f0, f1)
    np.testing.assert_allclose(b, np.moveaxis(((f0 + f1) / 2).numpy(), 0, -1), rtol=0,
                               atol=1e-6)
    r.render(dataclasses.replace(cam, position=(0.1, 0.1, 1.2)))
    assert r._frame == 1  # reset on move

    rm = trenderer.create_renderer(
        "Vulkan Ray Tracer", SettingsMap({"use_mlat": True, "num_nodes": 4,
                                          "bvhBuildAlgorithm": "binned_sah"}), device="cpu")
    rm.set_line_data(ld)
    m = rm.render(cam)
    want = trt.render_tubes_mlat(scene, *args, K=4, opacity=rm.opacity,
                                 bvh=trt.build_capsule_bvh(scene, builder="binned_sah"))
    np.testing.assert_array_equal(m, np.moveaxis(want.numpy(), 0, -1))
    assert m.shape == a.shape


def test_halton_matches_jax():
    from linevis_tpu.render.renderer import _halton

    for i in range(20):
        for base in (2, 3):
            assert trenderer._halton(i, base) == _halton(i, base)
