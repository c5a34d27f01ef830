"""linevis_tpu_torch transparent (MLAB) tube frame vs the JAX package on the CPU.

The kernel-level tests feed the port's own SortedBinning and params to the
JAX kernel (Pallas interpret mode) and to the port's plain version, so both
walk the same candidate order: MLAB results depend on run order (blocks and
the per-block limit of K tie windows follow it), and the JAX key sort is
unstable where the port's is stable. The whole-image tests use each
package's own frame prep. Bars:
- node depths within 1e-6 (~16 ulp at z_ndc ~0.99) and alpha within 1e-5,
  on >= 99.9% of pixels (alpha from the per-segment rows follows the hit's
  axial position and is held to the features' bars);
- node features (attr, cos1, cos2, premultiplied) and composited RGBA within
  2e-3 on >= 99.9% of pixels, within 1e-4 on >= 95% and within 1e-5 on
  >= 90% (measured: 99.98-100%, 97.5-98.1% and 94.0-94.2%). The spread
  sits at the float32 noise floor of the reference's own formulation: the
  re-origined oa'.oa' (~1e-3) is formed from |oa|^2 (~2) and t0*(oa.d + rd),
  so one ulp of the ray direction or of oa.d moves it by ~3e-7 and the hit
  depth at grazing angles by up to ~1e-5 (1e-4 .. 1e-3 of the headlight
  cosines at tube radius 0.03). XLA:CPU's rsqrt is not correctly rounded
  (1 ulp off on ~14% of inputs) and it contracts every multiply that feeds an
  add, so the two packages' rays differ by an ulp on many pixels (ROADMAP
  queue C);
- whole images at SSIM >= 0.999 and mean abs difference <= 2e-3, and the
  checked-in golden `mlab_transparent.png` at the golden harness's bar.
"""

import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.kernels import raster_capsule_oit as jk
from linevis_tpu.kernels.raster_pallas import SortedBinning as JSortedBinning
from linevis_tpu.render import oit as joit
from linevis_tpu.render import tube_raster as jtr
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.render.pipeline import RasterSettings as JSettings
from linevis_tpu_torch.convert import capsule_scene_from_numpy
from linevis_tpu_torch.entry import entry_mlab
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
from linevis_tpu_torch.render.transfer_function import (
    tf_channels_static,
    tf_static_table,
)

from tests import golden_scenes

torch.set_num_threads(1)

W, H = 96, 64
TILE = (16, 8)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "mlab_transparent.png")


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


def _port_frame(seg_alpha=None, opacity=0.4):
    """The port's frame prep of the walk scene -> (csr, params, settings)."""
    ts = ttr.build_capsule_scene(*_walk(), device="cpu")
    S = _settings(RasterSettings)
    if seg_alpha is not None:
        seg_alpha = torch.tensor(seg_alpha)
    csr, params = toit.prepare_mlab_frame(
        ts, *ttr.camera_tensors(_camera(Camera), "cpu"), S, opacity, seg_alpha
    )
    return csr, params, S


def _jax_kernel(csr, params, S, **kw):
    """The JAX kernel (interpret mode) on the port's binning and params."""
    jcsr = JSortedBinning(
        jnp.asarray(csr.payload.numpy()), jnp.asarray(csr.tile_start.numpy()),
        jnp.asarray(csr.tile_count.numpy()), csr.tiles_x, csr.tiles_y, csr.chunk,
    )
    out = jk.rasterize_capsules_mlab(
        jcsr, jnp.asarray(params.numpy()), W, H, *TILE, tf_color=S.tf_color,
        tf_opacity=S.tf_opacity, deferred_shade=True, interpret=True, **kw
    )
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _port_kernel(csr, params, S, **kw):
    launches = tk.rasterize_capsules_mlab.launches
    out = tk.rasterize_capsules_mlab(
        csr, params, W, H, *TILE, tf_color=S.tf_color, tf_opacity=S.tf_opacity,
        deferred_shade=True, **kw
    )
    assert tk.rasterize_capsules_mlab.launches == launches  # CPU: plain version
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def _check_nodes(j, t, alpha_is_feature=False):
    """alpha_is_feature: alpha = row 11 + row 12 * u follows the hit's axial
    position u, and with it the features' noise floor."""
    (jd, jf, ja), (td, tf, ta) = j, t
    assert td.shape == jd.shape and tf.shape == jf.shape and ta.shape == ja.shape
    assert (td < 2.0).sum() > 300  # the scene is on screen
    d_err = np.abs(jd - td).max(axis=0)
    a_err = np.abs(ja - ta).max(axis=0)
    f_err = np.abs(jf - tf).max(axis=(0, 1))
    assert (d_err <= 1e-6).mean() >= 0.999, d_err.max()
    if alpha_is_feature:
        _check_spread(a_err)
    else:
        assert (a_err <= 1e-5).mean() >= 0.999, a_err.max()
    _check_spread(f_err)


def _check_spread(err):
    assert (err <= 2e-3).mean() >= 0.999, err.max()
    assert (err <= 1e-4).mean() >= 0.95, (err <= 1e-4).mean()
    assert (err <= 1e-5).mean() >= 0.90, (err <= 1e-5).mean()


@pytest.mark.parametrize(
    "K,no_overflow,two_sided",
    list(itertools.product([4, 8, 16, 32], [False, True], [False, True])),
)
def test_mlab_nodes_match_jax(K, no_overflow, two_sided):
    csr, params, S = _port_frame()
    kw = dict(K=K, no_overflow=no_overflow, two_sided=two_sided)
    _check_nodes(_jax_kernel(csr, params, S, **kw), _port_kernel(csr, params, S, **kw))


def test_mlab_composite_matches_jax_and_deferred_resolve():
    csr, params, S = _port_frame()
    j = _jax_kernel(csr, params, S, K=8, composite=True)
    t = _port_kernel(csr, params, S, K=8, composite=True)
    err = np.abs(j - t).max(axis=0)
    assert t.shape == j.shape == (4, csr.tile_start.shape[0], 128)
    assert (t[3] > 0).sum() > 300
    _check_spread(err)

    # The in-kernel composite is shade_deferred_nodes plus the front-to-back
    # blend over the background.
    d, f, a = (torch.tensor(x) for x in _port_kernel(csr, params, S, K=8))
    rgb = toit.shade_deferred_nodes(d, f, a, params[9:11], params[11], params[12],
                                    params[13], S)
    T = torch.ones_like(a[0])
    acc = torch.zeros_like(rgb[:, 0])
    for i in range(8):
        acc = acc + T * rgb[:, i]
        T = T * (1.0 - a[i])
    resolved = torch.cat([acc + T * params[24:27, None, None], (1.0 - T)[None]])
    np.testing.assert_allclose(resolved.numpy(), t, rtol=0, atol=1e-6)


def test_mlab_composite_k32_matches_jax():
    """The composite at K=32 (the Per-Pixel Linked Lists mode's, config 2)."""
    csr, params, S = _port_frame()
    j = _jax_kernel(csr, params, S, K=32, composite=True)
    t = _port_kernel(csr, params, S, K=32, composite=True)
    assert t.shape == j.shape == (4, csr.tile_start.shape[0], 128)
    assert (t[3] > 0).sum() > 300
    _check_spread(np.abs(j - t).max(axis=0))


def test_mlab_alpha_from_rows_matches_jax():
    S_count = 10 * 7
    rng = np.random.default_rng(3)
    seg_alpha = np.stack([rng.uniform(0.1, 0.9, S_count),
                          rng.uniform(-0.3, 0.3, S_count)]).astype(np.float32)
    csr, params, S = _port_frame(seg_alpha=seg_alpha, opacity=0.5)
    # Payload rows 11-12 carry each pair's segment alpha times the opacity.
    ids = csr.payload[9, :int(csr.tile_count.sum())].long()
    live = ids < S_count
    for row, k in ((11, 0), (12, 1)):
        want = torch.tensor(seg_alpha[k] * np.float32(0.5))[ids[live]]
        assert torch.equal(csr.payload[row, :live.shape[0]][live], want)
    kw = dict(K=8, alpha_from_rows=True)
    j, t = _jax_kernel(csr, params, S, **kw), _port_kernel(csr, params, S, **kw)
    _check_nodes(j, t, alpha_is_feature=True)
    assert len(np.unique(t[2][t[0] < 2.0].round(3))) > 20  # per-segment alphas


def test_shade_deferred_nodes_matches_jax():
    rng = np.random.default_rng(7)
    K, T, P = 4, 6, 32
    alpha = rng.uniform(0, 1, (K, T, P)).astype(np.float32)
    alpha[0, 0, :4] = 0.0  # empty nodes
    feat = (rng.uniform(0, 1, (3, K, T, P)) * alpha).astype(np.float32)
    depths = rng.uniform(0.9, 0.999, (K, T, P)).astype(np.float32)
    ab = jtr._proj_constants(_camera(JCamera))
    args = (depths, feat, alpha, ab)
    S = _settings(RasterSettings)
    for use_bands in (False, True):
        j = joit.shade_deferred_nodes(*map(jnp.asarray, args), 1.0, 1.6, 0.4,
                                      _settings(JSettings), use_bands=use_bands)
        t = toit.shade_deferred_nodes(*map(torch.tensor, args), torch.tensor(1.0),
                                      torch.tensor(1.6), 0.4, S, use_bands=use_bands)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def _jax_scene():
    return golden_scenes._walk_scene(radius=0.03, seed=12)


def _port_scene(js):
    return capsule_scene_from_numpy(
        {f.name: np.asarray(getattr(js, f.name)) for f in dataclasses.fields(js)},
        device="cpu",
    )


def test_render_tubes_mlab_image_matches_jax_and_golden():
    """The whole frame of the golden scene (tests/golden_scenes.py
    scene_mlab_transparent: 64x48, K=8, opacity 0.4), each package with its
    own frame prep."""
    w, h = golden_scenes.SMALL_SIZE
    js = _jax_scene()
    jimg = golden_scenes.scene_mlab_transparent()
    timg = toit.render_tubes_mlab_image(
        _port_scene(js), _camera(Camera, w, h), settings=_settings(RasterSettings, w, h),
        K=8, opacity=0.4,
    )
    assert timg.shape == (h, w, 4) and np.isfinite(timg).all()
    assert (timg[..., 3] > 0).mean() > 0.05
    assert ssim(timg[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(timg - jimg).mean() <= 2e-3

    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(timg), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def test_render_tubes_atomic_loop_matches_jax():
    w, h = golden_scenes.SMALL_SIZE
    js = _jax_scene()
    jc = _camera(JCamera, w, h)
    j = np.asarray(joit.render_tubes_atomic_loop(
        js, jnp.asarray(jc.view_projection_matrix()),
        jnp.asarray(np.asarray(jc.position, np.float32)),
        jnp.asarray(jtr._proj_constants(jc)), _settings(JSettings, w, h), K=8, opacity=0.4,
    ))
    t = toit.render_tubes_atomic_loop(
        _port_scene(js), *ttr.camera_tensors(_camera(Camera, w, h), "cpu"),
        _settings(RasterSettings, w, h), K=8, opacity=0.4,
    ).numpy()
    assert t.shape == (4, h, w) and np.isfinite(t).all()
    assert ssim(np.moveaxis(t[:3], 0, -1), np.moveaxis(j[:3], 0, -1)) >= 0.999
    assert np.abs(t - j).mean() <= 2e-3


# Behaviour mirrored from tests/test_oit.py, on the port alone.

LW, LH = 32, 16


def _layered(n=4, radius=0.06):
    """n parallel horizontal tubes stacked in depth, all crossing center."""
    pos = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        pos[i, 0] = (-0.4, 0.0, 0.1 * i)
        pos[i, 1] = (0.4, 0.0, 0.1 * i)
    attrs = np.linspace(0.1, 0.9, n, dtype=np.float32)[:, None].repeat(2, 1)
    return ttr.build_capsule_scene(pos, np.ones((n, 2), bool), attrs, radius, device="cpu")


def _layered_settings():
    return RasterSettings(width=LW, height=LH, tile_w=16, tile_h=8, chunk=8,
                          span_x=3, span_y=3)


def _layered_image(scene, pos, K, opacity):
    cam = Camera(position=pos, width=LW, height=LH)
    return toit.render_tubes_mlab_image(scene, cam, settings=_layered_settings(), K=K,
                                        opacity=opacity)


def test_mlab_center_blend_matches_manual():
    n, opacity = 2, 0.4
    img = _layered_image(_layered(n), (0.0, 0.0, 1.5), 4, opacity)
    px = img[LH // 2, LW // 2]
    assert np.isfinite(img).all()
    # One front-face fragment per tube along the center ray.
    assert abs(px[3] - (1.0 - (1.0 - opacity) ** n)) < 1e-3, px
    assert (px[:3] < 1.0).all()


def test_mlab_opaque_limit_matches_opaque():
    """opacity=1: the first fragment wins, as in the opaque renderer."""
    scene = _layered(3)
    img_t = _layered_image(scene, (0.1, 0.05, 1.5), 4, 1.0)
    cam = Camera(position=(0.1, 0.05, 1.5), width=LW, height=LH)
    img_o = ttr.render_tubes_image(
        scene, cam, settings=dataclasses.replace(_layered_settings(), aa=False)
    )
    cov_t = img_t[..., 3] > 0.5
    cov_o = (img_o[..., :3] < 0.999).any(-1)
    assert (cov_t == cov_o).mean() > 0.98
    both = cov_t & cov_o
    assert np.abs(img_t[..., :3] - img_o[..., :3])[both].max() < 2e-2


def test_mlab_deterministic():
    scene = _layered(4)
    a = _layered_image(scene, (0.0, 0.1, 1.4), 2, 0.3)
    b = _layered_image(scene, (0.0, 0.1, 1.4), 2, 0.3)
    np.testing.assert_array_equal(a, b)


def test_mlab_k16_equals_k8_within_depth_complexity():
    """Four layers (depth complexity 4 <= 8): no overflow at either K, so
    the extra empty nodes change nothing."""
    scene = _layered(4)
    a = _layered_image(scene, (0.05, 0.1, 1.4), 8, 0.4)
    b = _layered_image(scene, (0.05, 0.1, 1.4), 16, 0.4)
    assert (a[..., 3] > 0.5).sum() > 20
    np.testing.assert_array_equal(a, b)


def test_saturation_culling_error_bound():
    """Rejection behind a saturated K-buffer (sat=0.99) stays within its
    bound against culling switched off (sat=2.0): everything dropped
    composites under T_K <= 1 - sat."""
    n = 24
    scene = _layered(n, radius=0.25)
    cam = Camera(position=(0.0, 0.0, 4.0), width=LW, height=LH)
    S = _layered_settings()
    csr, params = toit.prepare_mlab_frame(scene, *ttr.camera_tensors(cam, "cpu"), S, 0.7)
    tf_color = ((0.0, 0.2, 0.4, 0.9), (1.0, 0.9, 0.3, 0.1))

    def run(sat):
        K = 4
        d, feat, a = tk.rasterize_capsules_mlab(
            csr, params, LW, LH, 16, 8, K, tf_color, ((0.0, 1.0), (1.0, 1.0)),
            deferred_shade=True, sat=sat,
        )
        T = torch.ones_like(a[0])
        acc = torch.zeros_like(feat[:, 0])
        for i in range(K):
            acc = acc + T * feat[:, i]
            T = T * (1.0 - a[i])
        return acc.numpy(), (1.0 - T).numpy()

    f_cull, a_cull = run(0.99)
    f_full, a_full = run(2.0)  # alpha never reaches 2: rejection off
    assert np.isfinite(f_cull).all() and np.isfinite(f_full).all()
    assert np.abs(f_cull - f_full).max() <= 0.01 + 1e-5
    assert np.abs(a_cull - a_full).max() <= 0.01 + 1e-5
    assert a_full.max() > 0.99  # some pixel saturated: culling engaged


def test_plain_version_batches_do_not_change_result():
    csr, params, S = _port_frame()
    kw = dict(K=8, tf_color=S.tf_color, tf_opacity=S.tf_opacity)
    w1 = torch.zeros(csr.tile_start.shape[0], dtype=torch.int32)
    w2 = torch.zeros_like(w1)
    a = tk.rasterize_capsules_mlab_reference(csr, params, W, H, *TILE, work=w1,
                                             batch_tiles=5, **kw)
    b = tk.rasterize_capsules_mlab_reference(csr, params, W, H, *TILE, work=w2, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(w1, w2)
    assert (w1 <= csr.tile_count).all() and int(w1.sum()) > 0


def test_plain_version_counts_the_needed_work():
    """`stats` counts the front-face test's needed work (the smoke's B2
    bounds): every evaluation of the work count once, a part where its
    discriminant is not negative, a surface where one is hit before the
    clip. With no cull, the K-buffer and the accumulation modes count the
    same."""
    csr, params, S = _port_frame()
    keys = ("evaluations", "body", "start_cap", "end_cap", "surfaces")
    got = []
    for kw in (dict(K=32, deferred_shade=True, composite=True), dict(K=1, store_mode="count")):
        st, work = {}, torch.zeros(csr.tile_start.shape[0], dtype=torch.int32)
        tk.rasterize_capsules_mlab_reference(csr, params, W, H, *TILE, tf_color=S.tf_color,
                                             tf_opacity=S.tf_opacity, work=work, stats=st, **kw)
        assert st["evaluations"] == int(work.sum()) * TILE[0] * TILE[1]
        assert st["evaluations"] > st["body"] > st["surfaces"] >= st["hits"] > 300
        assert 0 < st["end_cap"] < st["evaluations"]
        assert 0 <= st["start_cap"] < st["evaluations"]
        # Every surface is the root of a part whose discriminant is not negative.
        assert st["body"] + st["start_cap"] + st["end_cap"] >= st["surfaces"]
        got.append({k: st[k] for k in keys})
    assert got[0] == got[1]


def test_row_product_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0.3, 1.0, (33, 16)).astype(np.float32)
    for n in range(1, 33):
        j = np.asarray(jk._row_product(jnp.asarray(x[:n]), n))
        t = tk._row_product(torch.tensor(x[:n]), n).numpy()
        np.testing.assert_array_equal(t, j)


def test_tf_static_matches_jax_kernel_tf():
    pts = ((0.0, 0.1, 0.2, 0.3), (0.3, 0.9, 0.1, 0.4), (0.3, 0.2, 0.8, 0.6),
           (0.71, 0.5, 0.5, 0.05), (1.0, 1.0, 0.0, 1.0))
    x = np.concatenate([np.linspace(-0.2, 1.2, 301), [0.3, 0.71, 1.0, 0.0]]).astype(np.float32)
    j = jk._tf_channels_static(pts, 3, jnp.asarray(x))
    t = tf_channels_static(pts, 3, torch.tensor(x))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)
    # At the shared endpoint 0.3 the later segment (0.3 -> 0.71) wins.
    assert t[0][-4].item() == pytest.approx(0.2)
    table = tf_static_table(pts, ((0.0, 0.5), (1.0, 1.0)))
    assert table.dtype == np.float32 and table[0] == 5 and table[1] == 2
    assert table.size == 2 + (3 + 4 * 9) + (1 + 1 * 5)


def test_entry_mlab_runs_on_cpu_and_defaults_to_cuda():
    fn, args = entry_mlab(device="cpu")
    img = fn(*args)
    assert img.shape == (4, 128, 256) and bool(torch.isfinite(img).all())
    assert bool((img[3] > 0).any()) and bool((img[:3] < 0.999).any())
    if torch.cuda.is_available():
        _, args = entry_mlab()
        assert args[0].a.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            entry_mlab()


def test_wrapper_rejects_other_devices():
    csr, params, S = _port_frame()
    meta = dataclasses.replace(csr, payload=csr.payload.to("meta"))
    with pytest.raises(ValueError):
        tk.rasterize_capsules_mlab(meta, params.to("meta"), W, H, *TILE, 8,
                                   S.tf_color, S.tf_opacity, deferred_shade=True)
