"""linevis_tpu_torch prism tube frame vs the JAX package on the CPU.

The kernel-level tests feed the port's own SortedBinning and params (from
`prepare_prism_frame`) to the JAX kernel (Pallas interpret mode) and to the
port's plain version. Bars:
- segment ids equal on >= 99.9% of pixels. They may differ where two prisms
  are hit at the same depth (shared ring edges of consecutive segments): the
  JAX kernel breaks such ties by the lowest id inside a `sub` block and by
  block order across blocks, the port by the lowest id (ROADMAP queue C);
- coverage (hit or miss) exact where the ids agree;
- z_ndc within 2e-6 and the G-buffer within 1e-5 where the ids agree
  (measured on these scenes: z 6e-8, attribute 3.9e-6, normal 1.1e-6, and no
  id differs). That is float32 round-off: the JAX kernel normalises the ray and the plane
  normals with `lax.rsqrt`, which XLA:CPU does not round correctly, and XLA
  fuses multiply-adds; the port uses 1/sqrt and unfused arithmetic. The hit
  distance t ~ 1.4 carries ~1e-7, the normal `oa + t*dn - ba*u` is a
  difference of numbers ~1 and inherits ~1e-6, the attribute divides by
  |ba|^2 ~ 1e-2;
- whole images at SSIM >= 0.999 and mean abs <= 2e-3 against the JAX
  package run as it is, and the checked-in golden at the golden harness's
  bar (SSIM >= 0.99, mean difference <= 2e-3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels.raster_pallas import SortedBinning as JSortedBinning
from linevis_tpu.kernels.raster_prism import rasterize_prisms_pallas
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu.render.transfer_function import TransferFunction as JTF
from linevis_tpu_torch.convert import prism_scene_from_numpy
from linevis_tpu_torch.entry import entry_prism
from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh
from linevis_tpu_torch.kernels.raster_prism import (
    MAX_SIDES,
    rasterize_prisms,
    rasterize_prisms_reference,
)
from linevis_tpu_torch.kernels.tiles import unpack_tiles
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.opaque import render_opaque
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction

from tests.test_torch_geometry import _golden_walk

torch.set_num_threads(1)

GOLDEN = __file__.replace("test_torch_prism.py", "golden/prism_tubes.png")


def _walk(L=10, P=8, seed=11, radius=0.02):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.07, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), attrs, radius


def _prism_frame(n_sides, W, H, chunk):
    scene = ttr.build_prism_scene(*_walk(), n_sides=n_sides, device="cpu")
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8, chunk=chunk,
                       span_x=4, span_y=4)
    cam = Camera(position=(0.1, 0.2, 1.4), width=W, height=H)
    csr, params, _ = ttr.prepare_prism_frame(scene, *ttr.camera_tensors(cam, "cpu"), S)
    assert csr.payload.shape[0] == 36
    return csr, params


def _jax_kernel(csr, params, W, H, **kw):
    jcsr = JSortedBinning(
        jnp.asarray(csr.payload.numpy()), jnp.asarray(csr.tile_start.numpy()),
        jnp.asarray(csr.tile_count.numpy()), csr.tiles_x, csr.tiles_y, csr.chunk,
    )
    z, ids, g = rasterize_prisms_pallas(
        jcsr, jnp.asarray(params.numpy()), W, H, 16, 8, interpret=True, **kw
    )
    return np.asarray(z), np.asarray(ids), [np.asarray(x) for x in g]


@pytest.mark.parametrize(
    "n_sides,sub,early_z,size",
    [(8, 32, True, (160, 120)), (8, 8, True, (96, 64)), (6, 32, True, (160, 120)),
     (8, 32, False, (160, 120))],
    ids=["s8_sub32", "s8_sub8", "s6_sub32", "s8_sub32_no_early_z"],
)
def test_prism_reference_matches_pallas(n_sides, sub, early_z, size):
    W, H = size
    csr, params = _prism_frame(n_sides, W, H, chunk=32)
    jz, jid, jg = _jax_kernel(csr, params, W, H, n_sides=n_sides, sub=sub,
                              use_early_z=early_z)
    launches = rasterize_prisms.launches
    work = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32)
    # The port has no early-z exit: it is held to the JAX kernel with its
    # exit on and off.
    tz, tid, tg = rasterize_prisms(csr, params, W, H, 16, 8, n_sides=n_sides, work=work)
    assert rasterize_prisms.launches == launches  # CPU: plain version
    assert torch.equal(work, csr.tile_count)
    tz, tid, tg = tz.numpy(), tid.numpy(), [g.numpy() for g in tg]

    assert tid.dtype == np.int32 and tid.shape == jid.shape
    agree = jid == tid
    assert agree.mean() >= 0.999
    hit = agree & (tid >= 0)
    assert hit.sum() > 0.04 * hit.size  # the scene is on screen
    miss = agree & (tid < 0)
    assert (tz[miss] == 2.0).all() and (jz[miss] == 2.0).all()
    np.testing.assert_array_equal(jg[7][agree], tg[7][agree])  # coverage
    assert set(np.unique(tg[7])) <= {0.0, 1.0}
    assert np.abs(jz - tz)[hit].max() <= 2e-6
    for j, t in zip(jg[:4], tg[:4]):  # attribute and radial normal
        assert np.abs(j - t)[hit].max() <= 1e-5
    for j, t in zip(jg[4:7], tg[4:7]):  # tangent = the segment vector
        np.testing.assert_array_equal(j[hit], t[hit])


def test_prism_reference_batches_do_not_change_result():
    W, H = 160, 120
    csr, params = _prism_frame(8, W, H, chunk=16)
    a = rasterize_prisms_reference(csr, params, W, H, 16, 8, batch_pairs=7)
    b = rasterize_prisms_reference(csr, params, W, H, 16, 8)
    for x, y in zip([a[0], a[1], *a[2]], [b[0], b[1], *b[2]]):
        assert torch.equal(x, y)


# ---- the four cases of tests/test_prism_raster.py on the port ----


def _render_prism_depth(scene, cam, settings):
    csr, params, basis = ttr.prepare_prism_frame(
        scene, *ttr.camera_tensors(cam, "cpu"), settings
    )
    depth_t, id_t, _ = rasterize_prisms(
        csr, params, settings.width, settings.height, settings.tile_w,
        settings.tile_h, n_sides=scene.n_sides,
    )

    def unp(x):
        return unpack_tiles(x, csr.tiles_x, csr.tiles_y, settings.tile_w,
                            settings.tile_h, settings.width, settings.height).numpy()

    return unp(depth_t), unp(id_t), basis


def _triangle_oracle_zndc(mesh, cam, basis, xs, ys, W, H):
    """float64 Moller-Trumbore nearest-hit NDC depth at pixel centres."""
    verts = mesh.vertices.numpy().astype(np.float64)  # [3, V]
    tris = mesh.triangles.numpy()
    tmask = mesh.triangle_mask.numpy()
    v0 = verts[:, tris[0]][:, tmask]
    e1 = verts[:, tris[1]][:, tmask] - v0
    e2 = verts[:, tris[2]][:, tmask] - v0
    basis = basis.numpy().astype(np.float64)
    o = np.asarray(cam.position, np.float64)
    A, B = ttr._proj_constants(cam).astype(np.float64)

    out = np.full(len(xs), 2.0)
    for i, (x, y) in enumerate(zip(xs, ys)):
        u = (x + 0.5) * 2.0 / W - 1.0
        v = 1.0 - (y + 0.5) * 2.0 / H
        d = basis[:, 0] * u + basis[:, 1] * v + basis[:, 2]
        invlen = 1.0 / np.linalg.norm(d)
        dn = d * invlen
        pvec = np.cross(dn[None, :], e2.T)  # [T, 3]
        det = np.sum(e1.T * pvec, axis=1)
        ok = np.abs(det) > 1e-14
        inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tvec = o[None, :] - v0.T
        uu = np.sum(tvec * pvec, axis=1) * inv_det
        qvec = np.cross(tvec, e1.T)
        vv = np.sum(dn[None, :] * qvec, axis=1) * inv_det
        tt = np.sum(e2.T * qvec, axis=1) * inv_det
        hit = ok & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-9)
        if hit.any():
            out[i] = A - B / (tt[hit].min() * invlen)
    return out


def test_prism_straight_matches_triangle_oracle():
    P = 6
    pos = np.zeros((1, P, 3), np.float32)
    pos[0, :, 0] = np.linspace(-0.45, 0.45, P)
    pos[0, :, 1] = 0.05
    mask = np.ones((1, P), bool)
    attrs = np.linspace(0, 1, P, dtype=np.float32)[None]
    radius = 0.07
    scene = ttr.build_prism_scene(pos, mask, attrs, radius, device="cpu")
    mesh = build_tube_triangle_mesh(pos, mask, attrs, radius=radius,
                                    num_subdivisions=8, device="cpu")
    W, H = 96, 64
    cam = Camera(position=(0.1, 0.3, 1.3), look_at_point=(0, 0, 0), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    depth, seg_id, basis = _render_prism_depth(scene, cam, S)

    hit_ys, hit_xs = np.nonzero(seg_id >= 0)
    assert hit_xs.size > 60  # the tube is visible at all
    rng = np.random.default_rng(7)
    pick = rng.choice(hit_xs.size, size=min(200, hit_xs.size), replace=False)
    xs = np.concatenate([rng.integers(0, W, 300), hit_xs[pick]])
    ys = np.concatenate([rng.integers(0, H, 300), hit_ys[pick]])
    oracle = _triangle_oracle_zndc(mesh, cam, basis, xs, ys, W, H)
    got = depth[ys, xs]
    o_hit = oracle < 1.5
    g_hit = seg_id[ys, xs] >= 0
    # Hit/miss decisions may differ only on silhouette edge pixels.
    assert np.mean(o_hit ^ g_hit) < 0.03
    both = o_hit & g_hit
    assert both.sum() > 30
    assert np.max(np.abs(got[both] - oracle[both])) < 2e-4


def test_prism_curved_matches_triangle_gbuffer_ssim():
    """The prism image against the port's own triangle G-buffer image."""
    L, P = 4, 24
    t = np.linspace(0, 2.5, P)
    pos = np.stack(
        [np.stack([0.4 * np.cos(t + i), 0.4 * np.sin(t + i),
                   0.15 * t - 0.2 + 0.05 * i], -1) for i in range(L)]
    ).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    mask = np.ones((L, P), bool)
    attrs = np.tile(np.linspace(0, 1, P)[None], (L, 1)).astype(np.float32)
    radius = 0.04
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.15, 1.4), look_at_point=(0, 0, 0), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    vp, cp, ab = ttr.camera_tensors(cam, "cpu")

    scene = ttr.build_prism_scene(pos, mask, attrs, radius, device="cpu")
    img_p = ttr.render_tubes_prism(scene, vp, cp, ab, S).numpy()
    mesh = build_tube_triangle_mesh(pos, mask, attrs, radius=radius,
                                    num_subdivisions=8, device="cpu")
    table = torch.as_tensor(TransferFunction.standard().table)
    img_t = render_opaque(mesh, vp, cp, table, S).numpy()

    assert np.isfinite(img_p).all()
    s = ssim(img_p[:3].mean(0), img_t[:3].mean(0))
    mad = float(np.abs(img_p - img_t).mean())
    assert s >= 0.98, f"prism vs exact-triangle SSIM {s}"
    assert mad < 4e-3, f"mean abs diff {mad}"


def test_prism_open_end_shows_background():
    P = 4
    pos = np.zeros((1, P, 3), np.float32)
    pos[0, :, 2] = np.linspace(0.4, -0.4, P)
    scene = ttr.build_prism_scene(pos, np.ones((1, P), bool),
                                  np.full((1, P), 0.5, np.float32), 0.1, device="cpu")
    W, H = 64, 48
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    # Exactly on-axis: back faces only -> pure background.
    cam0 = Camera(position=(0.0, 0.0, 1.3), look_at_point=(0, 0, 0), width=W, height=H)
    _, seg_id0, _ = _render_prism_depth(scene, cam0, S)
    assert (seg_id0 >= 0).sum() == 0
    # Slightly off-axis: outer wall visible, interior still see-through.
    cam = Camera(position=(0.18, 0.13, 1.2), look_at_point=(0, 0, 0.1), width=W, height=H)
    _, seg_id, _ = _render_prism_depth(scene, cam, S)
    assert (seg_id >= 0).sum() > 20
    assert seg_id[H // 2, W // 2] == -1


def test_prism_masked_and_single_segment():
    pos = np.zeros((2, 3, 3), np.float32)
    pos[0, :, 0] = [-0.3, 0.0, 0.3]
    pos[1, :, 0] = [-0.3, 0.0, 0.3]
    pos[1, :, 1] = 0.2
    mask = np.array([[True, True, True], [True, False, False]])
    scene = ttr.build_prism_scene(pos, mask, np.full((2, 3), 0.5, np.float32), 0.05,
                                  device="cpu")
    W, H = 64, 48
    cam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    _, seg_id, _ = _render_prism_depth(scene, cam, S)
    hits = np.unique(seg_id[seg_id >= 0])
    # Only line 0's two segments (ids 0, 1) may appear; line 1 is masked.
    assert hits.size > 0 and set(hits.tolist()) <= {0, 1}


def test_prism_triangle_parity_oracles_on_curved_tubes():
    """`automation/parity.py` on gently curved fat tubes at 160x120: its
    float64 oracles accept the pixels that both rasters cover, every pixel
    that only the prism frame covers falls in exactly one class, and at this
    size (edge constants ~2e4, ulp 0.002) the triangle raster's float32
    formulation loses no pixel that the mesh covers."""
    from linevis_tpu_torch.automation.parity import prism_triangle_parity

    L, P = 4, 24
    t = np.linspace(0, 2.5, P)
    pos = np.stack(
        [np.stack([0.4 * np.cos(t + i), 0.4 * np.sin(t + i),
                   0.15 * t - 0.2 + 0.05 * i], -1) for i in range(L)]
    ).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    attrs = np.tile(np.linspace(0, 1, P)[None], (L, 1)).astype(np.float32)
    W, H = 160, 120
    cam = Camera(position=(0.0, 0.15, 1.4), look_at_point=(0, 0, 0), width=W, height=H)
    S = RasterSettings(width=W, height=H, tile_w=16, tile_h=8)
    r = prism_triangle_parity(pos, np.ones((L, P), bool), attrs, 0.04, cam, S,
                              device="cpu")

    both = r["both_sample"]
    assert both["pixels"] > 1000
    for oracle in ("mesh", "screen", "edges_z_binned", "prism", "prism_f32"):
        assert both[oracle] >= 0.99 * both["pixels"], oracle
    only = r["prism_only"]
    classes = r["prism_only_classes"]
    assert sum(classes.values()) == only["pixels"]
    assert only["pixels"] + r["triangle_only"]["pixels"] <= 0.03 * both["pixels"]
    for lost in ("lost_to_edges", "lost_to_depth_plane", "lost_to_cull",
                 "lost_after_binning"):
        assert classes[lost] == 0, lost
    # The two frames' depths agree (measured: median 1.8e-5, 99th centile
    # 2.4e-4 on silhouette pixels, where planarized quad and triangle pair
    # differ most).
    assert r["both_abs_dz_median"] <= 5e-5 and r["both_abs_dz_p99"] <= 1e-3


# ---- the whole frame ----


def _jax_prism_scene_dict(js):
    return {
        "capsule": {f.name: getattr(js.capsule, f.name)
                    for f in dataclasses.fields(js.capsule)},
        "frames": js.frames, "n_sides": js.n_sides,
    }


def _renderer_settings(cls, tf, w, h):
    # linevis_tpu/render/renderer.py:LineRenderer._raster_settings for the
    # Opaque renderer with depth_cue_strength 0.2.
    c_pts, o_pts = tf.as_static_points()
    return cls(width=w, height=h, tile_w=32, tile_h=16, depth_cue_strength=0.2,
               tf_color=c_pts, tf_opacity=o_pts)


def test_render_tubes_prism_image_matches_jax_and_golden():
    """The golden scene (tests/golden_scenes.py scene_prism_tubes: the
    Opaque renderer with tubeGeometry 'prism' on _line_data(seed=11,
    width=0.04), supersample 2) through both packages, and against the
    checked-in golden."""
    w, h = 160, 120
    pos, mask, attrs = _golden_walk()
    js = jtr.build_prism_scene(pos, mask, attrs, radius=0.02, n_sides=8)
    jimg = jtr.render_tubes_prism_image(
        js, JCamera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h),
        tf=JTF.standard(), settings=_renderer_settings(JSettings, JTF.standard(), w, h),
        supersample=2,
    )
    ts = prism_scene_from_numpy(_jax_prism_scene_dict(js), device="cpu")
    tf = TransferFunction.standard()
    timg = ttr.render_tubes_prism_image(
        ts, Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h),
        tf=tf, settings=_renderer_settings(RasterSettings, tf, w, h), supersample=2,
    )
    assert timg.shape == (h, w, 4) and np.isfinite(timg).all()
    assert ssim(timg[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(timg - jimg).mean() <= 2e-3

    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(timg), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_prism_scene_from_numpy_matches_build_prism_scene():
    pos, mask, attrs = _golden_walk()
    mask[2, 5:] = False
    js = jtr.build_prism_scene(pos, mask, attrs, radius=0.02, n_sides=6)
    conv = prism_scene_from_numpy(_jax_prism_scene_dict(js), device="cpu")
    built = ttr.build_prism_scene(pos, mask, attrs, radius=0.02, n_sides=6, device="cpu")
    assert conv.n_sides == built.n_sides == 6
    assert conv.frames.dtype == torch.float32 and conv.frames.shape == built.frames.shape
    np.testing.assert_allclose(conv.frames.numpy(), built.frames.numpy(), rtol=0, atol=1e-5)
    for f in dataclasses.fields(built.capsule):
        a, b = getattr(conv.capsule, f.name), getattr(built.capsule, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b
    assert not bool(built.capsule.cap_a.any())  # open-ended: no start caps
    # Both render the same image.
    w, h = 96, 64
    cam = Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0), width=w, height=h)
    S = RasterSettings(width=w, height=h, tile_w=16, tile_h=8)
    a = ttr.render_tubes_prism_image(conv, cam, settings=S)
    b = ttr.render_tubes_prism_image(built, cam, settings=S)
    assert (a[..., :3] < 0.999).any()
    assert ssim(a[..., :3], b[..., :3]) >= 0.999 and np.abs(a - b).mean() <= 2e-3


def test_entry_prism_runs_on_cpu_and_defaults_to_cuda():
    fn, args = entry_prism(device="cpu")
    img = fn(*args)
    assert img.shape == (4, 128, 256) and bool(torch.isfinite(img).all())
    assert bool((img[:3] < 0.999).any())
    if torch.cuda.is_available():
        _, args = entry_prism()
        assert args[0].a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            entry_prism()


def test_prism_wrapper_rejects_bad_inputs():
    W, H = 64, 32
    csr, params = _prism_frame(8, W, H, chunk=16)
    for n_sides in (2, MAX_SIDES + 1):
        with pytest.raises(ValueError):
            rasterize_prisms(csr, params, W, H, 16, 8, n_sides=n_sides)
    no_frames = dataclasses.replace(csr, payload=csr.payload[:24])
    with pytest.raises(ValueError):
        rasterize_prisms(no_frames, params, W, H, 16, 8)
    meta = dataclasses.replace(csr, payload=csr.payload.to("meta"))
    with pytest.raises(ValueError):
        rasterize_prisms(meta, params.to("meta"), W, H, 16, 8)
