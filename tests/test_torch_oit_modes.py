"""linevis_tpu_torch: the rest of the OIT family vs the JAX package on the CPU.

Depth complexity, WBOIT, depth peeling, MLAB buckets and MBOIT
(`render/oit.py`), and the store modes of B2 they run: 'count', 'wboit',
`peel` with per-fragment shading (`deferred_shade=False`). The MBOIT
kernel modes 'mboit_gen' and 'mboit_resolve' are held against JAX in
`tests/test_torch_moment_math.py`.

The kernel-level tests feed the port's own SortedBinning and params to the
JAX kernel (Pallas interpret mode) and to the port's plain version, as
`tests/test_torch_oit.py` does. Bars:
- 'count' exactly;
- 'wboit': the revealage sum of log(1 - a) within 1e-6, the sum of w*a
  within 1e-5 of itself, the sum of w*a*rgb within 2e-3 of the pixel's sum
  of w*a on every pixel, within 1e-4 on >= 95% and within 1e-5 on >= 90%
  (measured: at most 1.4e-3, 96.1%, 94.0%): B2's spread. The colors are
  shaded per fragment, and the specular cos1^30 multiplies the f32 noise
  floor of the hit's headlight cosine (ROADMAP queue C, B2) by 30;
- peel + per-fragment K-buffer: node depths within 1e-6 and alpha within
  1e-5 on >= 99.9% of pixels, the premultiplied colors within 2e-3 on >=
  99.9% (B2's noise floor, the same cause);
- whole images (each package with its own frame prep) at SSIM >= 0.999 and
  mean abs <= 2e-3; the goldens `mboit.png` and `depth_peeling.png` at the
  golden harness's bars.
The behaviour tests of `tests/test_oit.py` run on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from linevis_tpu.kernels import raster_capsule_oit as jk
from linevis_tpu.kernels.raster_pallas import SortedBinning as JSortedBinning
from linevis_tpu.render import oit as joit
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch import entry as tentry
from linevis_tpu_torch.convert import capsule_scene_from_numpy
from linevis_tpu_torch.kernels import raster_capsule_oit as tk
from linevis_tpu_torch.render import oit as toit
from linevis_tpu_torch.render import tube_raster as ttr
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.transfer_function import TransferFunction

from tests import golden_scenes

torch.set_num_threads(1)

W, H = 96, 64
TILE = (16, 8)
GOLDEN_DIR = __file__.rsplit("/", 1)[0] + "/golden"


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


def _jax_kernel(csr, params, S, **kw):
    """The JAX kernel (interpret mode) on the port's binning and params."""
    jcsr = JSortedBinning(
        jnp.asarray(csr.payload.numpy()), jnp.asarray(csr.tile_start.numpy()),
        jnp.asarray(csr.tile_count.numpy()), csr.tiles_x, csr.tiles_y, csr.chunk,
    )
    out = jk.rasterize_capsules_mlab(
        jcsr, jnp.asarray(params.numpy()), W, H, *TILE, tf_color=S.tf_color,
        tf_opacity=S.tf_opacity, interpret=True, **kw
    )
    return tuple(np.asarray(o) for o in out)


def _port_kernel(csr, params, S, **kw):
    before = (tk.rasterize_capsules_mlab.launches, tk.rasterize_capsules_accum.launches)
    out = tk.rasterize_capsules_mlab(csr, params, W, H, *TILE, tf_color=S.tf_color,
                                     tf_opacity=S.tf_opacity, **kw)
    # CPU: the plain version, no kernel launch.
    assert (tk.rasterize_capsules_mlab.launches, tk.rasterize_capsules_accum.launches) == before
    return tuple(o.numpy() for o in out)


def _accum_frame():
    """The walk scene's capsule frame with the WBOIT params (opacity only)."""
    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    S = _settings(RasterSettings)
    csr, params, _ = ttr.prepare_capsule_frame(
        ts, *ttr.camera_tensors(_camera(Camera), "cpu"), S
    )
    params[14] = 0.4
    return csr, params, S


@pytest.mark.parametrize("two_sided", [False, True], ids=["front", "two_sided"])
def test_count_matches_jax_exactly(two_sided):
    csr, params, S = _accum_frame()
    j = _jax_kernel(csr, params, S, K=1, store_mode="count", two_sided=two_sided)
    t = _port_kernel(csr, params, S, K=1, store_mode="count", two_sided=two_sided)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    assert t[0].max() >= 5 and (t[0] > 0).sum() > 500


def test_wboit_sums_match_jax():
    csr, params, S = _accum_frame()
    j = _jax_kernel(csr, params, S, K=1, store_mode="wboit")
    t = _port_kernel(csr, params, S, K=1, store_mode="wboit")
    (jd, jc, ja), (td, tc, ta) = j, t
    assert (ja[0] > 0).sum() > 500
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(tc[:, 1:], 0.0)
    rel = np.abs(tc - jc).max(axis=(0, 1)) / np.maximum(ja[0], 1e-30)
    assert rel.max() <= 2e-3, rel.max()
    assert (rel <= 1e-4).mean() >= 0.95, (rel <= 1e-4).mean()
    assert (rel <= 1e-5).mean() >= 0.90, (rel <= 1e-5).mean()


@pytest.mark.parametrize("no_overflow", [True, False], ids=["exact", "mlab_merge"])
def test_peel_per_fragment_nodes_match_jax(no_overflow):
    """A depth-peeling pass (K=4 behind the farthest of the first two
    layers) with per-fragment shading, the JAX kernel's default. Each side
    peels behind its own first pass: the peel test compares a fragment's NDC
    depth with the one its own extraction formed, and the two packages round
    that depth differently by an ulp, which would duplicate or skip the
    boundary layer across them."""
    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    S = _settings(RasterSettings)
    csr, params = toit.prepare_mlab_frame(
        ts, *ttr.camera_tensors(_camera(Camera), "cpu"), S, 0.4
    )

    def peel_of(d):
        return np.where(d < 1.5, d, -1.0).max(axis=0)

    j_peel = peel_of(_jax_kernel(csr, params, S, K=2, no_overflow=True)[0])
    t_peel = peel_of(_port_kernel(csr, params, S, K=2, no_overflow=True)[0])
    assert (np.abs(j_peel - t_peel) <= 1e-6).mean() >= 0.999
    kw = dict(K=4, no_overflow=no_overflow)
    jd, jc, ja = _jax_kernel(csr, params, S, peel=jnp.asarray(j_peel), **kw)
    td, tc, ta = _port_kernel(csr, params, S, peel=torch.tensor(t_peel), **kw)
    assert (td < 2.0).sum() > 300  # layers behind the first two exist
    assert ((td > t_peel[None]) | (td == 2.0)).all()
    d_err = np.abs(jd - td).max(axis=0)
    a_err = np.abs(ja - ta).max(axis=0)
    c_err = np.abs(jc - tc).max(axis=(0, 1))
    assert (d_err <= 1e-6).mean() >= 0.999, d_err.max()
    assert (a_err <= 1e-5).mean() >= 0.999, a_err.max()
    assert (c_err <= 2e-3).mean() >= 0.999, c_err.max()


# Whole frames, each package with its own frame prep, at the golden size.

def _frames(name, *, jax_kw=None, port_kw=None, size=golden_scenes.SMALL_SIZE, opacity=0.4):
    w, h = size
    js = golden_scenes._walk_scene(radius=0.03, seed=12)
    jc = _camera(JCamera, w, h)
    j = np.asarray(getattr(joit, name)(
        js, jnp.asarray(jc.view_projection_matrix()),
        jnp.asarray(np.asarray(jc.position, np.float32)),
        jnp.asarray(jtr._proj_constants(jc)), _settings(JSettings, w, h),
        **(jax_kw or {}), **({} if opacity is None else {"opacity": opacity}),
    ))
    ts = capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)}, device="cpu",
    )
    t = getattr(toit, name)(
        ts, *ttr.camera_tensors(_camera(Camera, w, h), "cpu"), _settings(RasterSettings, w, h),
        **(port_kw or jax_kw or {}), **({} if opacity is None else {"opacity": opacity}),
    ).numpy()
    assert t.shape == j.shape and np.isfinite(t).all()
    return j, t


def _check_image(j, t):
    assert (t[3] > 0).mean() > 0.05
    s_ = ssim(np.moveaxis(t[:3], 0, -1), np.moveaxis(j[:3], 0, -1))
    assert s_ >= 0.999, s_
    assert np.abs(t - j).mean() <= 2e-3, np.abs(t - j).mean()


@pytest.mark.parametrize(
    "name,kw",
    [("render_tubes_wboit", {}),
     ("render_tubes_depth_peeling", dict(K=8, passes=4)),
     ("render_tubes_mlab_buckets", dict(K=8)),
     ("render_tubes_mboit", dict(n_mom=4))],
)
def test_renderer_matches_jax(name, kw):
    _check_image(*_frames(name, jax_kw=kw))


def test_render_depth_complexity_matches_jax():
    j, t = _frames("render_depth_complexity", opacity=None)
    assert t.shape == (golden_scenes.SMALL_SIZE[1], golden_scenes.SMALL_SIZE[0])
    np.testing.assert_array_equal(t, j)
    assert t.max() >= 3


def _golden(name, img):
    golden = np.asarray(load_png(f"{GOLDEN_DIR}/{name}.png"), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_golden_mboit():
    """tests/golden_scenes.py:scene_mboit: 4 power moments, opacity 0.4."""
    w, h = golden_scenes.SMALL_SIZE
    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    img = toit.render_tubes_mboit(
        ts, *ttr.camera_tensors(_camera(Camera, w, h), "cpu"), _settings(RasterSettings, w, h),
        n_mom=4, opacity=0.4,
    )
    _golden("mboit", np.moveaxis(img.numpy(), 0, -1))


def test_golden_depth_peeling():
    """tests/golden_scenes.py:scene_depth_peeling, drawn through the JAX
    package's renderer registry: the registry's `_line_data(seed=21)` as
    capsules of radius width/2, 16x8 tiles, no depth cue, the Standard TF,
    opacity 0.5, K=8 x 4 passes."""
    w, h = golden_scenes.SMALL_SIZE
    ld = golden_scenes._line_data(seed=21)
    ts = ttr.build_capsule_scene(
        ld.trajectories.positions, ld.get_filtered_point_mask(), ld.selected_attributes(),
        radius=ld.line_width / 2.0, device="cpu",
    )
    c_pts, o_pts = TransferFunction.standard().as_static_points()
    S = RasterSettings(width=w, height=h, tile_w=16, tile_h=8, tf_color=c_pts,
                       tf_opacity=o_pts)
    img = toit.render_tubes_depth_peeling(
        ts, *ttr.camera_tensors(_camera(Camera, w, h), "cpu"), S, opacity=0.5
    )
    _golden("depth_peeling", np.moveaxis(img.numpy(), 0, -1))


# Behaviour mirrored from tests/test_oit.py, on the port alone.

LW, LH = 32, 16


def _layered(n=3, radius=0.06):
    """n parallel horizontal tubes stacked in depth, all crossing centre."""
    pos = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        pos[i, 0] = (-0.4, 0.0, 0.1 * i)
        pos[i, 1] = (0.4, 0.0, 0.1 * i)
    attrs = np.linspace(0.1, 0.9, n, dtype=np.float32)[:, None].repeat(2, 1)
    return ttr.build_capsule_scene(pos, np.ones((n, 2), bool), attrs, radius, device="cpu")


def _layered_settings():
    return RasterSettings(width=LW, height=LH, tile_w=16, tile_h=8, chunk=8, span_x=3,
                          span_y=3)


def _layered_run(name, scene, **kw):
    cam = Camera(position=(0.0, 0.0, 1.5), width=LW, height=LH)
    out = getattr(toit, name)(scene, *ttr.camera_tensors(cam, "cpu"), _layered_settings(), **kw)
    return out.numpy() if out.dim() == 2 else np.moveaxis(out.numpy(), 0, -1)


def _exact(scene, opacity=0.4):
    cam = Camera(position=(0.0, 0.0, 1.5), width=LW, height=LH)
    return toit.render_tubes_mlab_image(scene, cam, settings=_layered_settings(), K=8,
                                        opacity=opacity)


def test_wboit_and_depth_complexity():
    n = 3
    scene = _layered(n)
    dc = _layered_run("render_depth_complexity", scene)
    assert dc[LH // 2, LW // 2] == n and dc[0, 0] == 0
    img = _layered_run("render_tubes_wboit", scene, opacity=0.4)
    assert np.isfinite(img).all()
    assert abs(img[LH // 2, LW // 2, 3] - (1.0 - 0.6 ** n)) < 1e-2


@pytest.mark.parametrize("trig", [False, True], ids=["power", "trigonometric"])
@pytest.mark.parametrize("n_mom", [4, 6, 8])
def test_mboit_vs_exact_blend(n_mom, trig):
    """MBOIT approximates exact sorted blending; its coverage is exact."""
    scene = _layered(3)
    exact = _exact(scene)
    img = _layered_run("render_tubes_mboit", scene, n_mom=n_mom, opacity=0.4,
                       trigonometric=trig)
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img[..., 3], exact[..., 3], atol=2e-3)
    diff = np.abs(img[..., :3] - exact[..., :3])
    assert diff.mean() < 0.02 and diff.max() < 0.25, (diff.mean(), diff.max())


@pytest.mark.parametrize("trig", [False, True], ids=["power", "trigonometric"])
def test_mboit_unorm16_pixel_format(trig):
    scene = _layered(3)
    f32 = _layered_run("render_tubes_mboit", scene, n_mom=4, opacity=0.4, trigonometric=trig)
    u16 = _layered_run("render_tubes_mboit", scene, n_mom=4, opacity=0.4, trigonometric=trig,
                       pixel_format="unorm16")
    assert np.isfinite(u16).all()
    np.testing.assert_allclose(u16[..., 3], f32[..., 3], atol=1e-4)
    diff = np.abs(u16[..., :3] - f32[..., :3])
    assert diff.mean() < 0.02 and diff.max() < 0.3, (diff.mean(), diff.max())
    assert diff.max() > 0  # the 16-bit grid changes the result


def test_mboit_single_layer_near_exact():
    scene = _layered(1)
    img = _layered_run("render_tubes_mboit", scene, opacity=0.5)
    assert np.abs(img - _exact(scene, 0.5)).max() < 0.06


def test_depth_peeling_exact_beyond_k():
    """K=2 x 4 passes equals exact blending of the 3 front faces (and of
    deeper scenes up to 8 layers)."""
    scene = _layered(3)
    img = _layered_run("render_tubes_depth_peeling", scene, K=2, passes=4, opacity=0.4)
    np.testing.assert_allclose(img, _exact(scene), atol=2e-3)
    # An empty pass does not re-blend earlier layers (monotone peel depth).
    more = _layered_run("render_tubes_depth_peeling", scene, K=2, passes=6, opacity=0.4)
    np.testing.assert_array_equal(more, img)


def test_mlab_buckets_near_exact():
    scene = _layered(3)
    img = _layered_run("render_tubes_mlab_buckets", scene, K=4, opacity=0.4)
    np.testing.assert_allclose(img, _exact(scene), atol=2e-3)


def test_depth_peeling_with_k_below_layers_splits_them():
    """One pass of K=1 peels only the nearest layer; four passes, all."""
    scene = _layered(3)
    one = _layered_run("render_tubes_depth_peeling", scene, K=1, passes=1, opacity=0.4)
    assert abs(one[LH // 2, LW // 2, 3] - 0.4) < 1e-3
    all_ = _layered_run("render_tubes_depth_peeling", scene, K=1, passes=4, opacity=0.4)
    assert abs(all_[LH // 2, LW // 2, 3] - (1.0 - 0.6 ** 3)) < 1e-3


@pytest.mark.parametrize(
    "name", ["entry_wboit", "entry_depth_peeling", "entry_mlab_buckets", "entry_mboit",
             "entry_depth_complexity"],
)
def test_entries_run_on_cpu_and_default_to_cuda(name):
    fn, args = getattr(tentry, name)(device="cpu")
    out = fn(*args)
    assert bool(torch.isfinite(out).all())
    if name == "entry_depth_complexity":
        assert out.shape == (128, 256) and out.max().item() >= 2
    else:
        assert out.shape == (4, 128, 256) and bool((out[3] > 0).any())
    if torch.cuda.is_available():
        assert getattr(tentry, name)()[1][0].a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            getattr(tentry, name)()


def test_mode_checks_match_jax():
    csr, params, S = _accum_frame()
    for kw in (dict(K=4, store_mode="mboit_gen"),
               dict(K=1, store_mode="wboit", deferred_shade=True),
               dict(K=8, deferred_shade=False, composite=True),
               dict(K=8, deferred_shade=True, composite=True,
                    peel=torch.zeros(csr.tile_start.shape[0], 128)),
               dict(K=1, store_mode="mboit_resolve")):
        with pytest.raises(ValueError):
            tk.rasterize_capsules_mlab(csr, params, W, H, *TILE, tf_color=S.tf_color,
                                       tf_opacity=S.tf_opacity, **kw)
