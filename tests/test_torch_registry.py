"""linevis_tpu_torch scene layer and renderer registry vs the JAX package on the CPU.

- The port-side behaviour of tests/test_scene_api.py (line-data statistics
  and cache, filters, SettingsMap, line-data settings, registry and
  fallback, the tube-geometry setting) and the transform cases of
  tests/test_core.py.
- Every mode name the JAX registry knows renders in the port ("Opaque
  (Triangle Mesh)" on a surface, the scattering modes on a
  `LineDataScattering` of the lines with a small cloud and exit
  directions, the others on lines); `UNPORTED_MODES` is empty. A flow file
  loads into `LineDataFlow` as in JAX (tests/test_torch_loaders.py has the
  loaders).
- The ported modes drawn by name at golden_scenes.SMALL_SIZE: Opaque
  (capsule and triangle), MLAB and Depth Complexity against the JAX
  registry's image of the same line data (SSIM >= 0.999, mean abs <=
  2e-3). A JAX registry frame costs 10-100 s of interpret-mode compiles
  here, so every other mode is held, bit for bit, against the port's render
  function called with the arguments the JAX registry passes; those
  functions are held against JAX in their own files
  (tests/test_torch_oit*.py, test_torch_prism.py,
  test_torch_opacity_optimization.py); the arguments come from the JAX
  registry's renderer of the same mode and settings. RTAO against the
  port's own `render_tubes_rtao` on the same device and samples (the JAX
  registry draws them from jax.random); the golden `depth_peeling.png`
  through the port's registry.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from linevis_tpu.core.settings import SettingsMap as JSettingsMap
from linevis_tpu.core.trajectories import RaggedTrajectories, pad_trajectories
from linevis_tpu.render import renderer as jrenderer
from linevis_tpu.scene.filters import LineLengthFilter as JLineLengthFilter
from linevis_tpu.scene.line_data import LineData as JLineData
from linevis_tpu.scene.line_data import LineDataFlow as JLineDataFlow
from linevis_tpu_torch.convert import trajectories_from_numpy
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.core.transforms import (
    apply_transform,
    parse_transform_string,
    rotation_matrix,
)
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.rtao import RtaoSettings, render_tubes_rtao
from linevis_tpu_torch.render.tube_raster import camera_tensors
from linevis_tpu_torch.scene.filters import LineLengthFilter, MaxLineAttributeFilter
from linevis_tpu_torch.scene.line_data import LineData, LineDataFlow

from tests import golden_scenes

torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _port_traj(t):
    """A JAX-package Trajectories as the port's."""
    return trajectories_from_numpy(dict(
        positions=t.positions, attributes=t.attributes, mask=t.mask,
        num_points=t.num_points, attribute_names=t.attribute_names))


def _traj(num_lines=6):
    # tests/test_scene_api.py:_traj
    positions, attributes = [], []
    for i in range(num_lines):
        n = 4 + 4 * i
        t = np.linspace(0, 1, n, dtype=np.float32)
        positions.append(np.stack([t * (0.1 + 0.1 * i), t * 0.2, 0 * t], -1))
        attributes.append(np.stack([t * (i + 1) / num_lines]))
    return _port_traj(pad_trajectories(RaggedTrajectories(positions, attributes, ["a"])))


def _line_data(seed):
    """tests/golden_scenes.py `_line_data(seed)` for both packages."""
    jld = golden_scenes._line_data(seed=seed)
    ld = LineData(_port_traj(jld.trajectories))
    ld.set_line_width(jld.line_width)
    return jld, ld


# tests/test_scene_api.py's behaviour on the port.

def test_line_data_stats_and_cache():
    ld = LineData(_traj(), name="test")
    assert ld.num_lines == 6
    lo, hi = ld.get_attribute_range()
    assert 0.0 <= lo < hi <= 1.0
    scene1 = ld.get_capsule_scene(device="cpu")
    assert ld.get_capsule_scene(device="cpu") is scene1  # cached
    ld.set_line_width(0.01)
    scene3 = ld.get_capsule_scene(device="cpu")
    assert scene3 is not scene1  # invalidated
    assert scene3.radius == pytest.approx(0.005)
    # The same statistics as the JAX package's LineData.
    jld = JLineData(pad_trajectories(RaggedTrajectories(
        [ld.trajectories.positions[i, :n] for i, n in enumerate(ld.trajectories.num_points)],
        [ld.trajectories.attributes[i, :, :n] for i, n in enumerate(ld.trajectories.num_points)],
        ["a"])))
    assert (ld.num_line_points, ld.num_line_segments) == (jld.num_line_points,
                                                           jld.num_line_segments)
    np.testing.assert_array_equal(ld.get_aabb(), jld.get_aabb())
    assert ld.get_attribute_range() == jld.get_attribute_range()


def test_filters_match_jax():
    ld = LineData(_traj())
    ld.add_filter(LineLengthFilter(min_length=0.3))
    mask = ld.get_filter_mask()
    assert 0 < mask.sum() < 6
    jmask = JLineLengthFilter(min_length=0.3).filter(ld.trajectories)
    np.testing.assert_array_equal(mask, jmask)
    ld.clear_filters()
    ld.add_filter(MaxLineAttributeFilter(0, lo=0.5, hi=1.0))
    assert ld.get_filter_mask().tolist() == [False, False, True, True, True, True]
    # Filtered points are excluded from the render representation.
    sc = ld.get_capsule_scene(device="cpu")
    assert int(sc.mask.sum()) < ld.trajectories.segment_mask().sum()


def test_settings_map():
    s = SettingsMap({"line_width": 0.004, "attribute": "a", "flag": True})
    assert s.get_float("line_width") == pytest.approx(0.004)
    assert s.get_bool("flag")
    assert s.get_value("attribute") == "a"
    s.add_key_value("v", "(1, 2, 3)")
    assert s.get_vec("v") == (1.0, 2.0, 3.0)
    j = JSettingsMap({"line_width": 0.004, "attribute": "a", "flag": True, "v": "(1, 2, 3)"})
    assert dict(s.items()) == dict(j.items())
    c = s.copy()
    c.update(SettingsMap({"n": 3}))
    assert c.get_int("n") == 3 and not s.has_key("n") and c != s


def test_line_data_settings():
    ld = LineData(_traj())
    ld.set_new_settings(SettingsMap({"line_width": 0.008, "attribute": "a"}))
    assert ld.line_width == pytest.approx(0.008) and ld.selected_attribute_index == 0


def test_representations_on_the_cpu(tmp_path):
    ld = LineData(_traj())
    ld.set_line_width(0.02)
    prisms = ld.get_prism_scene(num_subdivisions=6, device="cpu")
    mesh = ld.get_tube_mesh(num_subdivisions=6, device="cpu")
    assert prisms.n_sides == 6 and prisms.a.device.type == "cpu"
    assert mesh.num_subdivisions == 6 and mesh.positions.device.type == "cpu"
    assert ld.get_tube_mesh(num_subdivisions=6, device="cpu") is mesh
    # The line segments (once NotImplementedError, queue A8) equal JAX's.
    segs = ld.get_line_segments(device="cpu")
    jsegs = JLineData(ld.trajectories).get_line_segments()
    for name in ("p0", "p1", "attr0", "attr1", "line_id", "seg_id_in_line", "mask"):
        assert np.array_equal(getattr(segs, name).numpy(), np.asarray(getattr(jsegs, name))), name
    assert ld.get_line_segments(device="cpu") is segs
    flow = LineDataFlow(_traj())
    with pytest.raises(ValueError, match="no ribbon directions"):
        flow.get_ribbon_mesh(device="cpu")
    flow.set_ribbon_directions(np.tile([0.0, 0.0, 1.0], flow.trajectories.positions.shape[:2] + (1,)))
    ribbons = flow.get_ribbon_mesh(num_subdivisions=6, device="cpu")
    bands = flow.get_helicity_band_mesh(num_subdivisions=6, device="cpu")
    assert ribbons.num_subdivisions == bands.num_subdivisions == 6
    assert ribbons.positions.device.type == bands.positions.device.type == "cpu"
    assert flow.get_helicity_band_mesh(num_subdivisions=6, device="cpu") is bands
    # Loading from a file (once NotImplementedError, queue A7) against JAX.
    obj = tmp_path / "lines.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 2 0\nvt 0.2\nvt 0.5\nvt 0.9\nl 1 2 3\nl 2 3\n")
    loaded = LineDataFlow.load_from_file(str(obj), attribute_names=["speed"])
    jloaded = JLineDataFlow.load_from_file(str(obj), attribute_names=["speed"])
    for f in ("positions", "attributes", "mask", "num_points"):
        np.testing.assert_array_equal(getattr(loaded.trajectories, f),
                                      getattr(jloaded.trajectories, f))
    assert loaded.attribute_names == jloaded.attribute_names == ["speed"]
    assert loaded.name == str(obj) and loaded.num_lines == 2
    assert loaded.get_capsule_scene(device="cpu").a.device.type == "cpu"


def test_renderer_registry_and_fallback():
    assert "Opaque" in trenderer.RENDERING_MODE_ALL
    r = trenderer.create_renderer("Opaque", device="cpu")
    assert r.name == "Opaque" and r.device.type == "cpu"
    assert trenderer.create_renderer("Opaque").device.type == "cuda"  # the default
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        r2 = trenderer.create_renderer("Voxel Ray Casting (Lines)", device="cpu")
        assert r2.name == "Opaque"
        assert len(w) == 1


@pytest.mark.parametrize("mode", jrenderer.RENDERING_MODE_ALL)
def test_every_jax_mode_renders_or_names_its_queue_item(mode):
    """"Opaque (Triangle Mesh)" draws a surface (a tetrahedron), the
    scattering modes the golden scene's lines as a `LineDataScattering`
    (a 12^3 Gaussian cloud, 64 exit directions), every other mode the
    golden scene's lines. No mode is left unported."""
    assert mode in trenderer.RENDERING_MODE_ALL
    assert mode not in trenderer.UNPORTED_MODES
    jld, ld = _line_data(21)
    if mode in ("Line Density Map Renderer", "Spherical Heat Map Renderer",
                "Volumetric Path Tracer"):
        from linevis_tpu_torch.scene.line_data_scattering import LineDataScattering

        g = np.linspace(-1.0, 1.0, 12)
        zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
        dirs = np.random.default_rng(5).normal(size=(64, 3))
        ld = LineDataScattering(ld.trajectories, np.exp(-4.0 * (xx**2 + yy**2 + zz**2)),
                                exit_directions=dirs / np.linalg.norm(dirs, axis=1, keepdims=True))
    if mode == "Opaque (Triangle Mesh)":
        from linevis_tpu_torch.loaders.mesh_loader import (
            SurfaceMesh,
            compute_curvature_attribute,
            compute_vertex_normals,
        )
        from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData

        v = np.array([[0, 0, 0.3], [0.3, 0, -0.2], [-0.3, 0.1, -0.2], [0, -0.3, 0]], np.float32)
        t = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32)
        n = compute_vertex_normals(v, t)
        ld = TriangleMeshData(SurfaceMesh(v, t, n, compute_curvature_attribute(v, t, n)))
    w, h = 32, 16
    r = trenderer.create_renderer(mode, SettingsMap({}), device="cpu")
    r.set_line_data(ld)
    img = r.render(golden_scenes._camera(w, h))
    assert img.shape == (h, w, 4) and np.isfinite(img).all()


def test_opaque_tube_geometry_setting():
    """tubeGeometry = capsule | prism | triangle selects the raster geometry."""
    ld = LineData(_traj())
    ld.set_line_width(0.05)
    cam = Camera(position=(0.0, 0.1, 1.2), width=64, height=32)
    r = trenderer.create_renderer("Opaque", device="cpu")
    r.set_line_data(ld)
    assert r.tube_geometry == "capsule"
    img_cap = r.render(cam)
    assert img_cap.shape == (32, 64, 4) and np.isfinite(img_cap).all()
    r.set_new_settings(SettingsMap({"tubeGeometry": "triangle"}))
    assert r.tube_geometry == "triangle"
    img_tri = r.render(cam)
    fg_c = np.abs(img_cap[..., :3] - 1.0).max(-1) > 1e-4
    fg_t = np.abs(img_tri[..., :3] - 1.0).max(-1) > 1e-4
    assert fg_t.any() and (fg_c ^ fg_t).mean() < 0.08
    r.set_new_settings(SettingsMap({"tubeGeometry": "prism"}))
    assert r.tube_geometry == "prism"
    img_pr = r.render(cam)
    fg_p = np.abs(img_pr[..., :3] - 1.0).max(-1) > 1e-4
    assert fg_p.any() and (fg_p ^ fg_t).mean() < 0.03
    assert np.abs(img_pr - img_tri).mean() < 6e-3
    with pytest.raises(ValueError):
        r.set_new_settings(SettingsMap({"tubeGeometry": "dodecahedron"}))


# tests/test_core.py's transform cases on the port.

def test_transform_string_rotate():
    m = parse_transform_string("rotate(270°, 1, 0, 0)")
    out = apply_transform(m, np.array([[0.0, 1.0, 0.0]], np.float32))
    np.testing.assert_allclose(out, [[0.0, 0.0, -1.0]], atol=1e-6)


def test_transform_chain():
    m = parse_transform_string("translate(1, 2, 3) scale(2)")
    out = apply_transform(m, np.array([[1.0, 1.0, 1.0]], np.float32))
    np.testing.assert_allclose(out, [[3.0, 4.0, 5.0]], atol=1e-6)


def test_rotation_matrix_orthonormal():
    m = rotation_matrix(0.7, [1, 2, 3])[:3, :3]
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-6)
    assert np.linalg.det(m) == pytest.approx(1.0, abs=1e-6)


# The registry's modes against the JAX registry's images.

REGISTRY_CASES = [
    ("Opaque", {}),
    ("Opaque", {"tubeGeometry": "triangle", "depth_cue_strength": 0.2}),
    ("Multi-Layer Alpha Blending", {"opacity": 0.5}),
    ("Depth Complexity", {}),
]


@pytest.mark.parametrize("mode,settings", REGISTRY_CASES,
                         ids=[f"{m}{'-' + '-'.join(s) if s else ''}" for m, s in REGISTRY_CASES])
def test_registry_mode_matches_jax(mode, settings):
    w, h = golden_scenes.SMALL_SIZE
    jld, ld = _line_data(21)
    j = jrenderer.create_renderer(mode, JSettingsMap(settings))
    j.set_line_data(jld)
    jimg = np.asarray(j.render(golden_scenes._camera(w, h)))
    r = trenderer.create_renderer(mode, SettingsMap(settings), device="cpu")
    r.set_line_data(ld)
    img = r.render(golden_scenes._camera(w, h))
    assert img.shape == jimg.shape == (h, w, 4) and np.isfinite(img).all()
    assert ssim(img[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(img - jimg).mean() <= 2e-3


def _oit(name):
    from linevis_tpu_torch.render import oit

    return getattr(oit, name)


def _frame_of(fn, args):
    """The frame of the `render/oit.py` function `fn` with the arguments
    `args(j)` reads from the JAX registry's renderer `j` -> numpy [H, W, 4]."""
    def frame(j, scene_of, cam, settings):
        img = _oit(fn)(scene_of(), *camera_tensors(cam, "cpu"), settings, **args(j))
        return np.moveaxis(img.numpy(), 0, -1)
    return frame


def _prism_frame(j, scene_of, cam, settings):
    from linevis_tpu_torch.render.transfer_function import TransferFunction
    from linevis_tpu_torch.render.tube_raster import render_tubes_prism_image

    subdiv = int(j.settings.get_float("tubeNumSubdivisions", 8))
    return render_tubes_prism_image(scene_of(prism=subdiv), cam, TransferFunction.standard(),
                                    settings, supersample=2)


def _oo_frame(j, scene_of, cam, settings):
    from linevis_tpu_torch.render.opacity_optimization import OpacityOptimizationRenderer

    traj = j.line_data.trajectories
    r = OpacityOptimizationRenderer(scene_of(), traj.num_lines, traj.max_points, settings)
    return np.moveaxis(r.render(cam).numpy(), 0, -1)


def _k_opacity(j):
    return dict(K=j.K, opacity=j.opacity)


def _opacity(j):
    return dict(opacity=j.opacity)


def _mboit(j):
    return dict(n_mom=j.n_mom, opacity=j.opacity, trigonometric=not j.use_power_moments,
                pixel_format=j.pixel_format)


FUNCTION_CASES = [
    # (mode, settings, tiles the JAX registry uses, the function and its arguments)
    ("Opaque", {"tubeGeometry": "prism"}, (32, 16), _prism_frame),
    ("Per-Pixel Linked Lists", {}, (16, 8), _frame_of("render_tubes_mlab", _k_opacity)),
    ("WBOIT", {}, (16, 8), _frame_of("render_tubes_wboit", _opacity)),
    ("Weighted Blended Order Independent Transparency", {"opacity": 0.6}, (16, 8),
     _frame_of("render_tubes_wboit", _opacity)),
    ("Moment-Based OIT", {"usePowerMoments": "false", "numMoments": 6, "pixelFormat": "Unorm"},
     (16, 8), _frame_of("render_tubes_mboit", _mboit)),
    ("Depth Peeling", {"opacity": 0.5}, (16, 8), _frame_of("render_tubes_depth_peeling", _opacity)),
    ("Atomic Loop 64-Bit", {}, (16, 8), _frame_of("render_tubes_atomic_loop", _k_opacity)),
    ("MLAB (Buckets)", {}, (16, 8), _frame_of("render_tubes_mlab_buckets", _opacity)),
    ("Opacity Optimization", {}, (32, 16), _oo_frame),
]


@pytest.mark.parametrize("mode,settings,tiles,frame", FUNCTION_CASES,
                         ids=[c[0] + ("-" + "-".join(c[1]) if c[1] else "")
                              for c in FUNCTION_CASES])
def test_registry_mode_calls_its_render_function(mode, settings, tiles, frame):
    w, h = golden_scenes.SMALL_SIZE
    jld, ld = _line_data(21)
    cam = golden_scenes._camera(w, h)
    r = trenderer.create_renderer(mode, SettingsMap(settings), device="cpu")
    r.set_line_data(ld)
    img = r.render(cam)
    # The JAX registry's renderer of the mode: its raster settings and the
    # arguments it passes to its render function.
    j = jrenderer.create_renderer(mode, JSettingsMap(settings))
    j.set_line_data(jld)
    js = j._raster_settings(cam)
    assert (js.tile_w, js.tile_h) == tiles
    s = r._raster_settings(cam)
    assert (s.tile_w, s.tile_h, s.tf_color, s.tf_opacity, s.depth_cue_strength) == (
        js.tile_w, js.tile_h, js.tf_color, js.tf_opacity, js.depth_cue_strength)

    def scene_of(prism=None):
        if prism:
            return ld.get_prism_scene(prism, device="cpu")
        return ld.get_capsule_scene(device="cpu")

    want = frame(j, scene_of, cam, s)
    assert img.shape == (h, w, 4) and np.isfinite(img).all()
    np.testing.assert_array_equal(img, want)
    assert (np.abs(img[..., :3] - 1.0).max(-1) > 1e-3).mean() > 0.02


def test_rtao_mode_matches_its_render_function():
    """Two accumulated frames of the registry's RTAO against
    render_tubes_rtao's frames 0 and 1 on the same device (each frame's
    samples drawn there from RtaoSettings.seed + frame); a camera move
    restarts the accumulation at frame 0."""
    w, h = golden_scenes.SMALL_SIZE
    _, ld = _line_data(21)
    cam = golden_scenes._camera(w, h)
    r = trenderer.create_renderer("RTAO", device="cpu")
    r.set_line_data(ld)
    img = r.render(cam)
    img = r.render(cam)
    scene = ld.get_capsule_scene(device="cpu")
    rtao = RtaoSettings()

    def frame(camera, f):
        return render_tubes_rtao(scene, *camera_tensors(camera, "cpu"),
                                 r._raster_settings(camera), rtao, frame=f, grid=r._grid)

    frames = [frame(cam, f) for f in range(2)]
    assert not torch.equal(frames[0], frames[1])  # each frame draws new samples
    want = np.moveaxis(((frames[0] * 1 + frames[1]) / 2).numpy(), 0, -1)
    np.testing.assert_allclose(img, want, rtol=0, atol=1e-6)
    assert (img[..., :3] < 0.99).any()
    moved = cam.orbit(0.3, 0.1, 1.2)
    np.testing.assert_allclose(r.render(moved), np.moveaxis(frame(moved, 0).numpy(), 0, -1),
                               rtol=0, atol=1e-6)
    # "SVGF (Temporal)" (ported: tests/test_torch_denoise_deferred.py holds
    # it frame by frame) keeps counting frames across the camera's move.
    r.set_new_settings(SettingsMap({"denoiser": "SVGF (Temporal)"}))
    frame = r._frame
    img = r.render(cam)
    assert r._frame == frame + 1 and np.isfinite(img).all()
    assert r._svgf_state is not None and r._svgf_state.color.device.type == "cpu"


def test_depth_peeling_golden_through_the_registry():
    """tests/golden_scenes.py scene_depth_peeling: the registry's Depth
    Peeling (opacity 0.5) on `_line_data(seed=21)` at 64x48."""
    w, h = golden_scenes.SMALL_SIZE
    _, ld = _line_data(21)
    r = trenderer.create_renderer("Depth Peeling", SettingsMap({"opacity": 0.5}), device="cpu")
    r.set_line_data(ld)
    img = r.render(golden_scenes._camera(w, h))
    golden = np.asarray(load_png(os.path.join(GOLDEN_DIR, "depth_peeling.png")),
                        np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3
