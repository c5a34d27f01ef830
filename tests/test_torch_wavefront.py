"""linevis_tpu_torch wavefront BVH ray tracer vs the JAX package on the CPU.

Bars, each stated where it is checked:
- the four BVH builders' trees (left, right, leaf_prim, node_min, node_max)
  and the packed 8-wide `groups` IDENTICAL to the JAX package's;
- the kernel's plain version against the JAX kernel (Pallas interpret mode)
  on the same groups and rays, K 4/8/16, `no_overflow` on and off: node
  depths within 1e-6 and alpha within 1e-5 on >= 99.5% of rays, and there
  the premultiplied features (attr, cos1, cos2) within 2e-3 on >= 99.9% of
  rays, 1e-4 on >= 95%: the bars `tests/test_torch_oit.py` found for the
  same scalar identities (the re-origined oa'.oa' is formed from terms a
  thousand times larger; XLA:CPU contracts multiply-adds and its rsqrt is
  not correctly rounded, the port rounds every operation on its own);
- whole images at SSIM >= 0.999 and mean abs <= 2e-3.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels import bvh_wavefront as jwf
from linevis_tpu.ops import lbvh as jlbvh
from linevis_tpu.ops import wide_bvh as jwide
from linevis_tpu.render import ray_tracer as jrt
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import (
    capsule_scene_from_numpy,
    lbvh_from_numpy,
    wide_groups_from_numpy,
)
from linevis_tpu_torch.entry import entry_wavefront
from linevis_tpu_torch.kernels import bvh_wavefront as twf
from linevis_tpu_torch.ops import lbvh as tlbvh
from linevis_tpu_torch.ops import wide_bvh as twide
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import ray_tracer as trt
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import ssim
from linevis_tpu_torch.render.pipeline import RasterSettings

torch.set_num_threads(1)

W, H = 64, 48
TREE_FIELDS = ("left", "right", "leaf_prim", "node_min", "node_max")


def _walk(radius=0.03, seed=12, L=5, P=8):
    # tests/test_bvh_wavefront.py:_scene's inputs.
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _to_port(js):
    return capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}, "cpu"
    )


def _scenes(mask_every=0, **kw):
    pos, mask, attrs, radius = _walk(**kw)
    if mask_every:
        mask[:, ::mask_every] = False
    js = jtr.build_capsule_scene(pos, mask, attrs, radius=radius)
    return js, _to_port(js)


def _one_segment():
    pos = np.zeros((1, 2, 3), np.float32)
    pos[0, 0] = (-0.3, 0.0, 0.0)
    pos[0, 1] = (0.3, 0.0, 0.0)
    js = jtr.build_capsule_scene(pos, np.ones((1, 2), bool),
                                 np.full((1, 2), 0.5, np.float32), radius=0.05)
    return js, _to_port(js)


def _args(cam_cls, settings_cls):
    cam = cam_cls(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=W, height=H)
    S = settings_cls(width=W, height=H, tile_w=16, tile_h=8, chunk=32, span_x=3, span_y=3)
    return cam, S


def _jax_cam(cam):
    return (jnp.asarray(cam.view_projection_matrix()),
            jnp.asarray(np.asarray(cam.position, np.float32)),
            jnp.asarray(jtr._proj_constants(cam)))


def _assert_same_tree(jb, tb):
    tb = tb.numpy()
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)), getattr(tb, name),
                                      err_msg=name)


SCENES = {
    "walk": lambda: _scenes(L=7, P=9, seed=3),
    # Masked segments are parked at 1e7: every real centroid quantizes to
    # Morton code 0 and the linear tree is split by index alone.
    "masked": lambda: _scenes(L=7, P=9, seed=3, mask_every=4),
    "one_segment": _one_segment,
}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("builder", ["linear", "binned_sah", "sweep_sah", "ploc"])
def test_bvh_builders_match_jax(builder, scene):
    js, ts = SCENES[scene]()
    jb = jrt.build_capsule_bvh(js, builder=builder)
    tb = trt.build_capsule_bvh(ts, builder=builder)
    _assert_same_tree(jb, tb)
    n = ts.num_segments
    assert sorted(tb.numpy().leaf_prim.tolist()) == list(range(n))


def test_morton_codes_match_jax_and_collapse_under_masked_segments():
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jlbvh.morton_codes(jnp.asarray(pts))).astype(np.int64),
        tlbvh.morton_codes(torch.as_tensor(pts)).numpy(),
    )
    # The collapse: with one box parked at 1e7 the real centroids all fall
    # into quantization cell 0.
    _, ts = SCENES["masked"]()
    b = ts.a + ts.ba
    far = torch.full_like(ts.a, 1e7)
    lo = torch.where(ts.mask[None], torch.minimum(ts.a, b) - ts.radius, far).T
    hi = torch.where(ts.mask[None], torch.maximum(ts.a, b) + ts.radius, far).T
    c = 0.5 * (lo + hi)
    unit = (c - lo.amin(0)) / torch.clamp(hi.amax(0) - lo.amin(0), min=1e-12)
    codes = tlbvh.morton_codes(unit)
    assert (codes[ts.mask] == 0).all() and (~ts.mask).any()


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("builder", ["linear", "binned_sah"])
def test_pack_wide_bvh_matches_jax(builder, scene):
    """`groups` identical to the JAX package's loop, from a tree carried
    across as numpy; and the invariants of the packing."""
    js, ts = SCENES[scene]()
    jb = jrt.build_capsule_bvh(js, builder=builder)
    geo = [np.asarray(x) for x in (js.a, js.ba)]
    rest = [np.asarray(x) for x in (js.attr0, js.dattr, js.cap_a)]
    jw = jwide.pack_wide_bvh(jb, *geo, float(js.radius), *rest)
    carried = lbvh_from_numpy({n: np.asarray(getattr(jb, n)) for n in TREE_FIELDS})
    tw = twide.pack_wide_bvh(carried, *geo, float(ts.radius), *rest)
    assert tw.n_groups == jw.n_groups
    np.testing.assert_array_equal(tw.groups, jw.groups)
    np.testing.assert_array_equal(
        trt.build_wide_capsule_bvh(ts, builder=builder).numpy(), jw.groups
    )
    for name in ("LANE_BMIN", "LANE_BMAX", "LANE_PTR", "LANE_LEAF", "LANE_A", "LANE_BA",
                 "LANE_R", "LANE_BABA", "LANE_ATTR0", "LANE_DATTR", "LANE_CAPA", "LANE_ID"):
        assert getattr(twide, name) == getattr(jwide, name)

    rec = tw.groups.reshape(tw.n_groups, 8, 128)
    leaf = rec[..., twide.LANE_LEAF] > 0.5
    prims = rec[..., twide.LANE_ID][leaf].astype(np.int64)
    assert sorted(prims.tolist()) == list(range(ts.num_segments))
    ptrs = rec[..., twide.LANE_PTR]
    internal = ptrs >= 0
    assert not (leaf & internal).any()
    assert (ptrs[internal] < tw.n_groups).all()
    counts = np.bincount(ptrs[internal].astype(np.int64), minlength=tw.n_groups)
    assert counts[0] == 0 and (counts[1:] == 1).all()  # each group pointed to once
    pad = ~leaf & ~internal
    assert np.isinf(rec[pad][:, :6]).all() and (rec[..., twide.USED_LANES:] == 0).all()


def _kernel_inputs(ts, builder="linear"):
    tcam, tS = _args(Camera, RasterSettings)
    vp, cp, ab = ttr.camera_tensors(tcam, "cpu")
    groups = trt.build_wide_capsule_bvh(ts, builder=builder)
    return groups, trt.primary_rays(vp, cp, tS, 1e6), ab


def _compare_nodes(out_t, out_j, ray_share=0.995):
    (d_t, f_t, a_t), (d_j, f_j, a_j) = ([np.asarray(x) for x in o] for o in (out_t, out_j))
    assert d_t.shape == d_j.shape and f_t.shape == f_j.shape
    assert np.isfinite(f_t).all() and (d_t < 2.0).any()
    d_err = np.abs(d_t - d_j).max(axis=0)
    a_err = np.abs(a_t - a_j).max(axis=0)
    ok = (d_err <= 1e-6) & (a_err <= 1e-5)
    assert ok.mean() >= ray_share, ok.mean()
    f_err = np.abs(f_t - f_j).max(axis=(0, 1))[ok]
    assert (f_err <= 2e-3).mean() >= 0.999, (f_err <= 2e-3).mean()
    assert (f_err <= 1e-4).mean() >= 0.95, (f_err <= 1e-4).mean()
    return ok.mean(), f_err


@pytest.mark.parametrize("no_overflow", [False, True], ids=["mlab_merge", "no_overflow"])
@pytest.mark.parametrize("K", [4, 8, 16])
def test_wavefront_reference_matches_jax_kernel(K, no_overflow):
    """The kernel's plain version against the JAX kernel on the same groups
    and rays (the port's). K = 4 overflows on this scene (depth complexity
    up to ~10 surfaces), so the MLAB merge and the K-th-depth pruning both
    run. Measured at every K: depths within 5.4e-7 and alpha within 1e-5 on
    all 3,072 rays; features within 2e-3 on 99.97% of them, 1e-4 on 99.93%,
    1e-5 on 97.0%, at most 4.3e-3 (one grazing ray)."""
    _, ts = _scenes(radius=0.03, seed=12, L=10, P=8)
    groups, rays, ab = _kernel_inputs(ts)
    stats = torch.zeros((rays.shape[1] // 128, 6), dtype=torch.int64)
    out_t = twf.trace_wavefront_kbuffer(groups, rays, ab, K=K, opacity=0.4,
                                        no_overflow=no_overflow, stats=stats)
    out_j = jwf.trace_wavefront_kbuffer(
        jnp.asarray(groups.numpy()), jnp.asarray(rays.numpy()), jnp.asarray(ab.numpy()),
        K=K, opacity=0.4, no_overflow=no_overflow, interpret=True,
    )
    _compare_nodes(out_t, out_j)
    by = dict(zip(twf.STATS, stats.sum(dim=0).tolist()))
    assert by["visits"] >= by["leaf_visits"] > 0 and by["members"] >= by["sweeps"] > 0
    assert 1 <= int(stats[:, 5].max()) < twf.MAX_STACK
    if K == 4:
        full = np.asarray(out_t[0])[K - 1] < 2.0
        assert full.mean() > 0.02  # buffers do fill up


@pytest.mark.parametrize("K", [4, 8])
def test_own_windows_need_no_block_wide_sweep_count(K):
    """One ray block in which ray 0 crosses all 8 capsules of one leaf group
    (16 candidates in a single visit) beside rays that cross one capsule (2
    candidates) and rays that cross none. The JAX kernel runs
    min(block-wide candidate count, K) sweeps for every ray; the port lets
    each ray extract its own windows, at most K. Equal results show that a
    sweep without a candidate is a no-op."""
    pos = np.zeros((8, 2, 3), np.float32)
    for i in range(8):
        pos[i, 0] = (-0.05, 0.0, 0.1 * i)
        pos[i, 1] = (0.05, 0.0, 0.1 * i)
    js = jtr.build_capsule_scene(pos, np.ones((8, 2), bool),
                                 np.linspace(0, 1, 16, dtype=np.float32).reshape(8, 2),
                                 radius=0.02)
    ts = _to_port(js)
    groups = trt.build_wide_capsule_bvh(ts, builder="binned_sah")
    assert groups.shape[0] == 8  # one group of 8 leaf rows
    rays = np.zeros((8, 128), np.float32)
    rays[:, 0] = (0.01, 0.0, -1.0, 0.0, 0.0, 1.0, 1e6, 1.0)
    for i in range(8):  # rays 1-8: straight down onto capsule i
        rays[:, 1 + i] = (0.0, 0.5, 0.1 * i, 0.0, -1.0, 0.0, 1e6, 1.0)
    for i in range(9, 64):  # valid rays that miss everything
        rays[:, i] = (0.3, 0.5, 0.01 * i, 0.0, -1.0, 0.0, 1e6, 1.0)
    ab = np.array([100.0 / 99.99, 100.0 * 0.01 / 99.99], np.float32)
    stats = torch.zeros((1, 6), dtype=torch.int64)
    out_t = twf.trace_wavefront_kbuffer(groups, torch.as_tensor(rays), torch.as_tensor(ab),
                                        K=K, opacity=0.5, stats=stats)
    out_j = jwf.trace_wavefront_kbuffer(
        jnp.asarray(groups.numpy()), jnp.asarray(rays), jnp.asarray(ab), K=K, opacity=0.5,
        interpret=True,
    )
    d_t = out_t[0].numpy()
    assert (d_t[:, 0, 0] < 2.0).sum() == K  # ray 0 fills its buffer
    assert ((d_t[:, 0, 1:9] < 2.0).sum(axis=0) == 2).all()  # entry + exit
    assert (d_t[:, 0, 9:] == 2.0).all()
    # 16 + 8 * 2 fragments; ray 0 extracts at most K windows in its visit.
    assert stats[0].tolist()[:5] == [1, 1, 8, min(16, K) + 16, min(16, K) + 16]
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)


def test_stack_overflow_raises():
    """A chain of groups that each push 8 wanted children passes MAX_STACK:
    the wrapper raises instead of writing out of bounds."""
    n_groups = 40
    rec = np.zeros((n_groups * 8, 128), np.float32)
    rec[:, 0:3] = -1.0
    rec[:, 3:6] = 1.0
    rec[:, twide.LANE_PTR] = -1.0
    for g in range(n_groups - 1):
        # Every row is an internal child that every ray wants; row 7 leads on.
        rec[g * 8:g * 8 + 8, twide.LANE_PTR] = n_groups - 1
        rec[g * 8 + 7, twide.LANE_PTR] = g + 1
    rec[(n_groups - 1) * 8:, 0:6] = np.inf
    rays = np.zeros((8, 128), np.float32)
    rays[:, :] = np.array([0, 0, -5, 0, 0, 1, 1e6, 1], np.float32)[:, None]
    ab = torch.tensor([1.0001, 0.010001])
    with pytest.raises(twf.StackOverflowError):
        twf.trace_wavefront_kbuffer(torch.as_tensor(rec), torch.as_tensor(rays), ab, K=4)


def test_render_wavefront_matches_jax():
    """Whole frame, each package's own tree and rays: SSIM >= 0.999 and mean
    abs <= 2e-3 (measured 0.999999998 and 6.8e-7)."""
    js, ts = _scenes(L=10)
    jcam, jS = _args(JCamera, JSettings)
    tcam, tS = _args(Camera, RasterSettings)
    img_j = np.asarray(jrt.render_tubes_raytraced_wavefront(
        js, *_jax_cam(jcam), jS, K=8, opacity=0.4, interpret=True
    ))
    before = twf.trace_wavefront_kbuffer.launches
    img_t = trt.render_tubes_raytraced_wavefront(
        ts, *ttr.camera_tensors(tcam, "cpu"), tS, K=8, opacity=0.4
    ).numpy()
    assert twf.trace_wavefront_kbuffer.launches == before  # no launch on the CPU
    assert img_t.shape == img_j.shape == (4, H, W) and np.isfinite(img_t).all()
    assert (img_t[3] > 0).mean() > 0.05
    s_ = ssim(np.moveaxis(img_t[:3], 0, -1), np.moveaxis(img_j[:3], 0, -1))
    mad = float(np.abs(img_t - img_j).mean())
    assert s_ >= 0.999 and mad <= 2e-3, (s_, mad)


def test_wavefront_matches_mlab_two_sided():
    """Depth complexity <= K: the wavefront K-buffer and the raster MLAB
    K-buffer extract the same surfaces with the same dedup window and
    deferred shading (tests/test_bvh_wavefront.py's bars)."""
    _, ts = _scenes()
    tcam, tS = _args(Camera, RasterSettings)
    cam = ttr.camera_tensors(tcam, "cpu")
    wf = trt.render_tubes_raytraced_wavefront(ts, *cam, tS, K=16, opacity=0.4).numpy()
    ml = toit.render_tubes_mlab(ts, *cam, tS, K=16, opacity=0.4, two_sided=True).numpy()
    diff = np.abs(wf - ml)
    assert np.isfinite(wf).all()
    assert diff.mean() < 2e-3, diff.mean()
    assert (diff > 0.05).mean() < 0.01, (diff > 0.05).mean()


def test_wavefront_builders_agree():
    """Linear vs binned-SAH trees traverse to the same image up to the
    arrival-order dependent MLAB merge of fragments beyond K
    (tests/test_bvh_wavefront.py's bars)."""
    _, ts = _scenes(seed=7)
    tcam, tS = _args(Camera, RasterSettings)
    cam = ttr.camera_tensors(tcam, "cpu")
    imgs = [
        trt.render_tubes_raytraced_wavefront(
            ts, *cam, tS, K=8, opacity=0.5,
            wide_groups=trt.build_wide_capsule_bvh(ts, builder=b),
        ).numpy()
        for b in ("linear", "binned_sah")
    ]
    diff = np.abs(imgs[0] - imgs[1])
    assert np.isfinite(imgs[0]).all()
    assert diff.max() < 5e-3, diff.max()
    assert (diff > 1e-4).mean() < 0.005, (diff > 1e-4).mean()


def test_wavefront_single_segment_and_tile_check():
    _, ts = _one_segment()
    tcam, tS = _args(Camera, RasterSettings)
    cam = ttr.camera_tensors(tcam, "cpu")
    img = trt.render_tubes_raytraced_wavefront(ts, *cam, tS, K=4, opacity=1.0).numpy()
    assert np.isfinite(img).all() and (img[3] > 0.5).any()
    with pytest.raises(ValueError, match="128"):
        trt.render_tubes_raytraced_wavefront(
            ts, *cam, dataclasses.replace(tS, tile_w=32, tile_h=16)
        )
    with pytest.raises(ValueError, match="builder"):
        trt.build_capsule_bvh(ts, builder="median")


def test_blocks_subset_and_carried_groups():
    """`blocks` restricts the plain version to some ray blocks (blocks are
    independent): the same nodes as the full trace, there."""
    js, ts = _scenes()
    groups, rays, ab = _kernel_inputs(ts, "binned_sah")
    groups = wide_groups_from_numpy(groups.numpy(), "cpu")
    full = twf.trace_wavefront_kbuffer_reference(groups, rays, ab, K=8)
    blocks = torch.arange(1, rays.shape[1] // 128, 5)
    part = twf.trace_wavefront_kbuffer_reference(groups, rays, ab, K=8, blocks=blocks)
    assert torch.equal(part[0], full[0][:, blocks])
    assert torch.equal(part[1], full[1][:, :, blocks])
    assert torch.equal(part[2], full[2][:, blocks])


def test_entry_wavefront_runs_on_cpu():
    fn, args = entry_wavefront(device="cpu")
    img = fn(*args).numpy()
    assert img.shape == (4, 128, 256) and np.isfinite(img).all()
    assert (img[3] > 0).mean() > 0.05
