"""linevis_tpu_torch stress lines and bands vs the JAX package on the CPU.

- The stress `.dat` loaders (v1 with a hierarchy file, v2, v3 with a hull,
  degenerate points) read the same files into equal arrays, and the port's
  writers write the JAX writers' bytes (tests/test_loaders.py,
  tests/test_bands.py round trips).
- `pad_trajectories` and `LineDataStress`'s merged arrays, PS indices,
  opacity rows and filters are equal to JAX's (tests/test_scene_api.py
  `test_stress_model`, tests/test_bands.py).
- The elliptic tube, band (RIBBONS), principal-stress (EIGENVALUE_RATIO,
  HYPERSTREAMLINES), ribbon and helicity meshes agree with JAX within
  MESH_ULPS = 16 units in the last place of each array's largest magnitude
  (measured: at most 0.5 in positions, 2 in tangents, 9.9 in normals; XLA
  contracts the cross products' and ring sums' multiply-adds, the port does
  not, and the helicity twist goes through sin/cos of a running sum);
  triangle lattices and masks exactly.
- The golden `tests/golden/stress_bands.png` through the port, at the golden
  harness's bars (SSIM >= 0.99, mean difference <= 2e-3).
- Degenerate-point spheres (a near-zero-length capsule) render as in JAX.
- A small Femur (config 4's scene) MLAB and MBOIT frame through the port's
  registry against the JAX registry's: SSIM >= 0.999, mean abs <= 2e-3.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.render_stress_bands import synth_v3_blocks as jsynth
from linevis_tpu.core import trajectories as jtraj
from linevis_tpu.core.settings import SettingsMap as JSettingsMap
from linevis_tpu.geometry import bands as jbands
from linevis_tpu.geometry import tubes as jtubes
from linevis_tpu.loaders import stress_dat as jdat
from linevis_tpu.render import renderer as jrenderer
from linevis_tpu.scene.line_data import LineDataFlow as JLineDataFlow
from linevis_tpu.scene.line_data_stress import LineDataStress as JLineDataStress
from linevis_tpu_torch.core import trajectories as ttraj
from linevis_tpu_torch.core.settings import SettingsMap
from linevis_tpu_torch.entry import femur_line_data, synth_v3_blocks
from linevis_tpu_torch.geometry import bands as tbands
from linevis_tpu_torch.geometry import tubes as ttubes
from linevis_tpu_torch.loaders import stress_dat as tdat
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.oit import render_tubes_mlab
from linevis_tpu_torch.render.opaque import render_opaque_image
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.tube_raster import camera_tensors, render_tubes_image
from linevis_tpu_torch.scene.line_data import LineDataFlow
from linevis_tpu_torch.scene.line_data_stress import LineDataStress

from tests import golden_scenes

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "stress_bands.png")
MESH_ULPS = 16


def _ulps(a, b):
    """Largest |a - b| in units in the last place of max(|b|)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.spacing(np.float32(max(np.abs(b).max(), 1e-30)))
    return float(np.abs(a - b).max() / scale)


def _mesh_agrees(t, j):
    """A port TubeMesh against a JAX TubeMesh."""
    for name in ("positions", "normals", "tangents", "attrs"):
        u = _ulps(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
        assert u <= MESH_ULPS, (name, u)
    np.testing.assert_array_equal(t.triangles.numpy(), np.asarray(j.triangles))
    np.testing.assert_array_equal(t.triangle_mask.numpy(), np.asarray(j.triangle_mask))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert t.num_subdivisions == j.num_subdivisions


def _block(pkg, rng, ps_index=0, num_lines=3, n=6, v3=False):
    # tests/test_bands.py:_make_block for either package's classes.
    ragged, stress = ((jtraj.RaggedTrajectories, jdat.RaggedStressTrajectories) if pkg == "jax"
                      else (ttraj.RaggedTrajectories, tdat.RaggedStressTrajectories))
    block = stress(trajectories=ragged([], [], []), ps_index=ps_index)
    for li in range(num_lines):
        pos = rng.normal(size=(n + li, 3)).astype(np.float32)
        block.trajectories.positions.append(pos)
        right = rng.normal(size=(n + li, 3)).astype(np.float32)
        right /= np.linalg.norm(right, axis=1, keepdims=True)
        block.band_points_left.append(-right)
        block.band_points_right.append(right)
        if v3:
            block.band_points_left_unsmoothed.append(-right * 1.1)
            block.band_points_right_unsmoothed.append(right * 1.1)
            attrs = rng.normal(size=(9, n + li)).astype(np.float32)
            attrs[1] = np.abs(attrs[0])
            block.trajectories.attributes.append(attrs)
            block.hierarchy_levels.append([0.1 * li, 0.2, 0.3, 0.4])
            block.appearance_orders.append(li)
            block.seed_positions.append(pos[0])
        else:
            block.trajectories.attributes.append(rng.normal(size=(1, n + li)).astype(np.float32))
            block.hierarchy_levels.append([0.1 * li])
    return block


def _hull(pkg, rng):
    cls = jdat.SimulationMeshHull if pkg == "jax" else tdat.SimulationMeshHull
    return cls(vertices=rng.normal(size=(8, 3)).astype(np.float32),
               triangles=np.array([[0, 1, 2], [4, 5, 6]], np.int32), mesh_type="cartesian")


def _blocks_equal(t_blocks, j_blocks):
    assert len(t_blocks) == len(j_blocks)
    for t, j in zip(t_blocks, j_blocks):
        assert t.ps_index == j.ps_index
        assert t.trajectories.attribute_names == j.trajectories.attribute_names
        for field in ("positions", "attributes"):
            for a, b in zip(getattr(t.trajectories, field), getattr(j.trajectories, field),
                            strict=True):
                np.testing.assert_array_equal(a, b)
        for field in ("major_ps", "medium_ps", "minor_ps", "major_ps_dir", "medium_ps_dir",
                      "minor_ps_dir", "band_points_left", "band_points_right",
                      "band_points_left_unsmoothed", "band_points_right_unsmoothed",
                      "seed_positions"):
            for a, b in zip(getattr(t, field), getattr(j, field), strict=True):
                np.testing.assert_array_equal(a, b)
        assert t.hierarchy_levels == j.hierarchy_levels
        assert t.appearance_orders == j.appearance_orders


def _write_v1(path, with_ps_names=True):
    # tests/test_loaders.py:test_stress_dat_v1's and tests/test_scene_api.py's
    # blocks: three of them, two lines each.
    def line(n, y):
        pos = " ".join(f"{i * 0.5} {0.1 * i} {y}" for i in range(n))
        ps = " ".join(str(v) for i in range(n)
                      for v in [3.0 + i, 1, 0, 0, 2.0, 0, 1, 0, -1.0 - i, 0, 0, 1])
        vm = " ".join(str(7.0 + i) for i in range(n))
        return f"{n}\n{pos}\n{ps}\n{vm}\n"

    text = ""
    for name, y, n in (("major", 0.0, 2), ("medium", 0.3, 3), ("minor", 0.5, 4)):
        text += (f"{name} 2\n" if with_ps_names else "2\n") + line(n, y) + line(n + 1, -y)
    path.write_text(text)


def test_stress_dat_v1_with_hierarchy_matches_jax(tmp_path):
    dat, hier = tmp_path / "psl.dat", tmp_path / "psl_hier.dat"
    _write_v1(dat)
    hier.write_text("major 2\n0.2\n0.9\nmedium 2\n0.5\n0.1\nminor 2\n1.0\n0.3\n")
    t = tdat.load_stress_trajectories_from_dat_v1([str(dat)], [str(hier)])
    j = jdat.load_stress_trajectories_from_dat_v1([str(dat)], [str(hier)])
    assert t[0] == j[0] == [0, 1, 2]
    _blocks_equal(t[1], j[1])
    # tests/test_loaders.py:test_stress_dat_v1's values on the first line.
    b = t[1][0]
    np.testing.assert_allclose(b.major_ps[0], [3.0, 4.0])
    np.testing.assert_allclose(b.trajectories.attributes[0][0], [7.0, 8.0])
    assert b.hierarchy_levels == [[0.2], [0.9]]
    # Unnamed blocks: three of them take the indices 0, 1, 2.
    _write_v1(dat, with_ps_names=False)
    t = tdat.load_stress_trajectories_from_dat_v1([str(dat)])
    j = jdat.load_stress_trajectories_from_dat_v1([str(dat)])
    assert t[0] == j[0] == [0, 1, 2]
    _blocks_equal(t[1], j[1])


def test_stress_dat_v2_round_trip_matches_jax(tmp_path):
    tblocks = [_block("torch", np.random.default_rng(5), 0), _block("torch", np.random.default_rng(6), 2)]
    jblocks = [_block("jax", np.random.default_rng(5), 0), _block("jax", np.random.default_rng(6), 2)]
    tp, jp = str(tmp_path / "t_v2.dat"), str(tmp_path / "j_v2.dat")
    tdat.write_stress_trajectories_dat_v2(tp, tblocks)
    jdat.write_stress_trajectories_dat_v2(jp, jblocks)
    assert filecmp.cmp(tp, jp, shallow=False)
    t = tdat.load_stress_trajectories_from_dat_v2([tp])
    j = jdat.load_stress_trajectories_from_dat_v2([jp])
    assert t[0] == j[0] == [0, 2]
    _blocks_equal(t[1], j[1])
    for orig, got in zip(tblocks, t[1]):
        for a, b in zip(orig.trajectories.positions, got.trajectories.positions):
            np.testing.assert_allclose(a, b, rtol=1e-5)


def test_stress_dat_v3_round_trip_with_hull_matches_jax(tmp_path):
    tblocks = [_block("torch", np.random.default_rng(10 + i), i, v3=True) for i in range(3)]
    jblocks = [_block("jax", np.random.default_rng(10 + i), i, v3=True) for i in range(3)]
    tp, jp = str(tmp_path / "t_v3.dat"), str(tmp_path / "j_v3.dat")
    tdat.write_stress_trajectories_dat_v3(tp, tblocks, _hull("torch", np.random.default_rng(1)))
    jdat.write_stress_trajectories_dat_v3(jp, jblocks, _hull("jax", np.random.default_rng(1)))
    assert filecmp.cmp(tp, jp, shallow=False)
    tps, t, th = tdat.load_stress_trajectories_from_dat_v3([tp])
    jps, j, jh = jdat.load_stress_trajectories_from_dat_v3([jp])
    assert tps == jps == [0, 1, 2]
    _blocks_equal(t, j)
    assert t[0].trajectories.attributes[0].shape[0] == 13  # 9 measured + 4 derived
    np.testing.assert_array_equal(th.vertices, jh.vertices)
    np.testing.assert_array_equal(th.triangles, jh.triangles)
    assert th.mesh_type == jh.mesh_type
    attrs9 = np.random.default_rng(3).normal(size=(9, 5)).astype(np.float32)
    np.testing.assert_array_equal(tdat._principal_stress_attrs(attrs9),
                                  jdat._principal_stress_attrs(attrs9))


def test_degenerate_points_dat_matches_jax(tmp_path):
    path = tmp_path / "degenerate.dat"
    path.write_text("3\n0.1 0.2 0.3\n-1 0 2.5\n4 5 6\n")
    t = tdat.load_degenerate_points_dat(str(path))
    np.testing.assert_array_equal(t, jdat.load_degenerate_points_dat(str(path)))
    assert t.shape == (3, 3) and t.dtype == np.float32


@pytest.mark.parametrize("pad_multiple,max_points", [(8, None), (8, 5), (1, None), (4, 17)])
def test_pad_trajectories_matches_jax(pad_multiple, max_points):
    rng = np.random.default_rng(7)
    lengths = (3, 11, 1, 9)
    pos = [rng.normal(size=(n, 3)).astype(np.float32) for n in lengths]
    att = [rng.normal(size=(2, n)).astype(np.float32) for n in lengths]
    t = ttraj.pad_trajectories(ttraj.RaggedTrajectories(pos, att, ["u", "v"]), max_points,
                               pad_multiple)
    j = jtraj.pad_trajectories(jtraj.RaggedTrajectories(pos, att, ["u", "v"]), max_points,
                               pad_multiple)
    for f in ("positions", "attributes", "mask", "num_points"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert getattr(t, f).dtype == getattr(j, f).dtype
    assert t.attribute_names == j.attribute_names
    empty = ttraj.pad_trajectories(ttraj.RaggedTrajectories([], [], ["u"]))
    jempty = jtraj.pad_trajectories(jtraj.RaggedTrajectories([], [], ["u"]))
    assert empty.positions.shape == jempty.positions.shape == (0, 8, 3)


def _v3_file(tmp_path, rng_seed=42, lines_per_ps=8, n=24, with_hull=True):
    """tests/golden_scenes.py:scene_stress_bands's v3 file (synth_v3_blocks
    and the ring hull), written by each package -> (port path, JAX path)."""
    theta = np.linspace(0, 2 * np.pi, 9, dtype=np.float32)[:-1]
    ring = np.stack([0.5 * np.cos(theta), 0.5 * np.sin(theta), 0 * theta - 1], 1)
    top = ring.copy()
    top[:, 2] = 1
    verts = np.concatenate([ring, top]).astype(np.float32)
    k = len(theta)
    tris = []
    for i in range(k):
        q = [i, (i + 1) % k, k + (i + 1) % k, k + i]
        tris += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
    tris = np.array(tris, np.int32)
    tp, jp = str(tmp_path / "t_psl_v3.dat"), str(tmp_path / "j_psl_v3.dat")
    tdat.write_stress_trajectories_dat_v3(
        tp, synth_v3_blocks(np.random.default_rng(rng_seed), lines_per_ps, n),
        tdat.SimulationMeshHull(verts, tris) if with_hull else None)
    jdat.write_stress_trajectories_dat_v3(
        jp, jsynth(np.random.default_rng(rng_seed), lines_per_ps, n),
        jdat.SimulationMeshHull(verts, tris) if with_hull else None)
    assert filecmp.cmp(tp, jp, shallow=False)
    return tp, jp


def _stress_equal(t, j):
    """LineDataStress merged state of the port against JAX's, exactly."""
    for f in ("positions", "attributes", "mask", "num_points"):
        np.testing.assert_array_equal(getattr(t.trajectories, f), getattr(j.trajectories, f))
    np.testing.assert_array_equal(t.line_ps_index, j.line_ps_index)
    np.testing.assert_array_equal(t.band_right_vectors, j.band_right_vectors)
    np.testing.assert_array_equal(t.principal_stresses, j.principal_stresses)
    np.testing.assert_array_equal(t.get_line_hierarchy_opacities(),
                                  j.get_line_hierarchy_opacities())
    np.testing.assert_array_equal(t.get_segment_opacity_rows(), j.get_segment_opacity_rows())
    np.testing.assert_array_equal(t.get_line_ps_colors(), j.get_line_ps_colors())
    np.testing.assert_array_equal(t.get_filter_mask(), j.get_filter_mask())
    assert t.attribute_names == j.attribute_names
    assert (t.num_lines, t.num_line_points, t.num_line_segments) == (
        j.num_lines, j.num_line_points, j.num_line_segments)
    np.testing.assert_array_equal(t.get_aabb(), j.get_aabb())


def test_line_data_stress_v3_matches_jax(tmp_path):
    tp, jp = _v3_file(tmp_path)
    t = LineDataStress.load_from_dat([tp], version=3)
    j = JLineDataStress.load_from_dat([jp], version=3)
    assert t.use_bands and t.hull is not None and len(t.attribute_names) == 13
    np.testing.assert_array_equal(t.hull.vertices, j.hull.vertices)
    for tt, jj in zip(t.trajectories_ps, j.trajectories_ps, strict=True):
        np.testing.assert_array_equal(tt.positions, jj.positions)
    np.testing.assert_array_equal(np.concatenate(t.appearance_order_ps),
                                  np.concatenate(j.appearance_order_ps))
    _stress_equal(t, j)
    # Filters and animation change the merge alike.
    for ld in (t, j):
        ld.set_hierarchy_slider(0, 0.3)
        ld.set_used_ps_directions([True, False, True])
        ld.set_hierarchy_mapping_curve(2, [(0.0, 0.2), (0.5, 1.0)])
    _stress_equal(t, j)
    for ld in (t, j):
        ld.set_used_ps_directions([True, True, True])
        ld.set_seed_animation_step(3)
    _stress_equal(t, j)
    assert 0 < int(t.trajectories.mask.any(axis=1).sum()) < t.num_lines
    # The hull's surface (once NotImplementedError, queue A6) equals JAX's.
    th, jh = t.get_hull_surface(), j.get_hull_surface()
    for f in ("vertices", "triangles", "normals", "attributes"):
        a, b = getattr(th, f), getattr(jh, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert th.triangles.shape[0] > 0 and t.get_hull_surface() is th


def test_line_data_stress_v1_v2_match_jax(tmp_path):
    # tests/test_scene_api.py:test_stress_model on both packages.
    dat = tmp_path / "psl.dat"
    _write_v1(dat)
    t = LineDataStress.load_from_dat([str(dat)])
    j = JLineDataStress.load_from_dat([str(dat)])
    _stress_equal(t, j)
    assert t.band_right_vectors is None
    for ld in (t, j):
        ld.set_used_ps_directions([True, False, True])
    _stress_equal(t, j)
    assert int(t.trajectories.mask.any(axis=1).sum()) == 4
    for ld in (t, j):
        ld.set_used_ps_directions([True, True, True])
        ld.set_hierarchy_slider(0, 1.1)
    _stress_equal(t, j)
    with pytest.raises(ValueError, match="no band geometry"):
        t.get_band_tube_mesh(device="cpu")
    # v2: bands, one scalar field, a transform applied to positions and bands.
    v2 = str(tmp_path / "psl_v2.dat")
    tdat.write_stress_trajectories_dat_v2(
        v2, [_block("torch", np.random.default_rng(4), 0), _block("torch", np.random.default_rng(8), 1)])
    m = np.diag([2.0, 1.0, 0.5, 1.0]).astype(np.float32)
    m[:3, 3] = (0.1, -0.2, 0.3)
    t = LineDataStress.load_from_dat([v2], version=2, transform=m)
    j = JLineDataStress.load_from_dat([v2], version=2, transform=m)
    _stress_equal(t, j)
    with pytest.raises(ValueError, match="version 4"):
        LineDataStress.load_from_dat([v2], version=4)


def test_hierarchy_mapping_curve_opacity():
    """tests/test_bands.py:test_hierarchy_mapping_curve_opacity on the port:
    the curve fades the low-hierarchy line through the MLAB kernel's alpha
    rows."""
    lines = []
    for y in (-0.15, 0.15):
        ln = np.zeros((4, 3), np.float32)
        ln[:, 0] = np.linspace(-0.4, 0.4, 4)
        ln[:, 1] = y
        lines.append(ln)
    traj = ttraj.pad_trajectories(ttraj.RaggedTrajectories(
        positions=lines, attributes=[np.full((1, 4), 0.5, np.float32)] * 2,
        attribute_names=["a"]))
    hier = np.array([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9]], np.float32)
    ld = LineDataStress(trajectories_ps=[traj], ps_indices=[0], hierarchy_levels_ps=[hier])
    ld.set_line_width(0.1)
    ld.set_hierarchy_mapping_curve(0, [(0.0, 0.0), (1.0, 1.0)])
    np.testing.assert_allclose(ld.get_line_hierarchy_opacities(), [0.1, 0.9], atol=1e-6)
    cam = Camera(position=(0.0, 0.0, 1.4), width=32, height=16)
    s = RasterSettings(width=32, height=16, tile_w=16, tile_h=8, span_x=3, span_y=3, chunk=8)
    img = render_tubes_mlab(
        ld.get_capsule_scene(device="cpu"), *camera_tensors(cam, "cpu"), s, K=4, opacity=1.0,
        seg_alpha=torch.tensor(ld.get_segment_opacity_rows())).numpy()
    assert img[3, :8].max() > 0.75
    assert img[3, 8:].max() < 0.35


def test_degenerate_point_spheres_render():
    """tests/test_bands.py:test_degenerate_point_spheres_render on the port,
    and the frame against JAX's: the spheres' ba is (w * 1e-3, 0, 0), a
    near-zero-length capsule, and leaves no non-finite pixel."""
    from linevis_tpu.render.camera import Camera as JCamera
    from linevis_tpu.render.pipeline import RasterSettings as JRasterSettings
    from linevis_tpu.render.tube_raster import render_tubes_image as jrender

    line = np.zeros((5, 3), np.float32)
    line[:, 0] = np.linspace(-0.4, 0.4, 5)
    args = dict(positions=[line], attributes=[np.full((1, 5), 0.2, np.float32)],
                attribute_names=["a"])
    pts = np.array([[0.0, 0.25, 0.0]], np.float32)
    ld = LineDataStress([ttraj.pad_trajectories(ttraj.RaggedTrajectories(**args))], [0],
                        degenerate_points=pts)
    jld = JLineDataStress([jtraj.pad_trajectories(jtraj.RaggedTrajectories(**args))], [0],
                          degenerate_points=pts)
    kw = dict(width=64, height=48, tile_w=16, tile_h=8, span_x=3, span_y=3)
    cam_kw = dict(position=(0.0, 0.0, 1.4), width=64, height=48)
    imgs = []
    for show in (False, True):
        for d in (ld, jld):
            d.set_line_width(0.12)
            d.set_show_degenerate_points(show)
        img = render_tubes_image(ld.get_capsule_scene(device="cpu"), Camera(**cam_kw),
                                 settings=RasterSettings(**kw))
        jimg = np.asarray(jrender(jld.get_capsule_scene(), JCamera(**cam_kw),
                                  settings=JRasterSettings(**kw)))
        assert np.isfinite(img).all()
        assert ssim(img[..., :3], jimg[..., :3]) >= 0.999
        assert np.abs(img - jimg).mean() <= 2e-3
        imgs.append(img)
    scene = ld.get_capsule_scene(device="cpu")
    assert scene.num_segments == jld.get_capsule_scene().a.shape[1]
    np.testing.assert_array_equal(scene.ba[:, -1].numpy(), np.float32([0.12 * 1e-3, 0, 0]))
    fg_base = (imgs[0][..., :3] < 0.999).any(-1)
    fg_pts = (imgs[1][..., :3] < 0.999).any(-1)
    added = fg_pts & ~fg_base
    assert added.sum() > 10
    assert np.nonzero(added)[0].mean() < 24
    reds = imgs[1][added]
    assert (reds[:, 0] > reds[:, 2]).mean() > 0.8


def _walk(seed=5, L=4, P=12):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.08, (L, P, 3)), axis=1).astype(np.float32)
    mask = np.ones((L, P), bool)
    mask[1, 9:] = False
    pos[1, 9:] = pos[1, 8]
    attrs = rng.uniform(0, 1, (L, P)).astype(np.float32)
    right = rng.normal(size=(L, P, 3)).astype(np.float32)
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    stress = rng.normal(0, 1.0, (3, L, P)).astype(np.float32)
    stress[1, 0, 3] = 0.0  # a zero stress: the eigenvalue ratio's guard
    return pos, mask, attrs, right, stress


def test_elliptic_tube_mesh_matches_jax():
    pos, mask, attrs, _, _ = _walk()
    for ratio in (1.0, 0.35):
        t = ttubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02, num_subdivisions=6,
                                            ellipse_ratio=ratio, device="cpu")
        j = jtubes.build_tube_triangle_mesh(pos, mask, attrs, radius=0.02, num_subdivisions=6,
                                            ellipse_ratio=ratio)
        _mesh_agrees(t, j)


def test_central_difference_tangents_match_jax():
    pos, mask, _, _, _ = _walk()
    t = tbands.central_difference_tangents(torch.tensor(pos), torch.tensor(mask)).numpy()
    j = np.asarray(jbands.central_difference_tangents(jnp.asarray(pos), jnp.asarray(mask)))
    assert _ulps(t, j) <= MESH_ULPS


@pytest.mark.parametrize("mode", ["RIBBONS", "EIGENVALUE_RATIO", "HYPERSTREAMLINES"])
def test_band_meshes_match_jax(mode):
    pos, mask, attrs, right, stress = _walk()
    if mode == "RIBBONS":
        t = tbands.build_band_tube_mesh(pos, mask, attrs, right, band_width=0.02,
                                        min_band_thickness=0.2, num_subdivisions=8, device="cpu")
        j = jbands.build_band_tube_mesh(pos, mask, attrs, right, band_width=0.02,
                                        min_band_thickness=0.2, num_subdivisions=8)
    else:
        psi = np.array([0, 1, 2, 1], np.int32)
        kw = dict(band_width=0.02, hyperstreamline=mode == "HYPERSTREAMLINES",
                  num_subdivisions=8)
        t = tbands.build_principal_stress_tube_mesh(pos, mask, attrs, right, psi, *stress,
                                                    device="cpu", **kw)
        j = jbands.build_principal_stress_tube_mesh(pos, mask, attrs, right, psi, *stress, **kw)
    _mesh_agrees(t, j)


@pytest.mark.parametrize("mode", ["RIBBONS", "EIGENVALUE_RATIO", "HYPERSTREAMLINES"])
def test_line_data_stress_band_mesh_matches_jax(tmp_path, mode):
    tp, jp = _v3_file(tmp_path, lines_per_ps=4, n=12, with_hull=False)
    t = LineDataStress.load_from_dat([tp], version=3)
    j = JLineDataStress.load_from_dat([jp], version=3)
    for ld in (t, j):
        ld.set_hierarchy_slider(1, 0.2)
        ld.set_band_render_mode(mode)
    _mesh_agrees(t.get_band_tube_mesh(band_width=0.012, num_subdivisions=6, device="cpu"),
                 j.get_band_tube_mesh(band_width=0.012, num_subdivisions=6))
    with pytest.raises(ValueError):
        t.set_band_render_mode("TUBES")


def _flow_pair():
    pos, mask, attrs, right, _ = _walk(seed=9)
    att = np.stack([attrs, np.sin(np.arange(pos.shape[1], dtype=np.float32))[None]
                    .repeat(pos.shape[0], 0) - 0.3], axis=1).astype(np.float32)
    traj = ttraj.Trajectories(pos, att, mask, mask.sum(1).astype(np.int32), ["a", "Helicity"])
    jt = jtraj.Trajectories(pos, att, mask, mask.sum(1).astype(np.int32), ["a", "Helicity"])
    return LineDataFlow(traj), JLineDataFlow(jt), right


def test_ribbon_and_helicity_meshes_match_jax():
    t, j, right = _flow_pair()
    with pytest.raises(ValueError, match="no ribbon directions"):
        t.get_ribbon_mesh(device="cpu")
    for ld in (t, j):
        ld.set_ribbon_directions(right)
        ld.helicity_rotation_factor = 0.7
    _mesh_agrees(t.get_ribbon_mesh(band_width=0.01, num_subdivisions=6, device="cpu"),
                 j.get_ribbon_mesh(band_width=0.01, num_subdivisions=6))
    tm = t.get_helicity_band_mesh(band_width=0.01, num_subdivisions=6, device="cpu")
    assert t.get_helicity_band_mesh(band_width=0.01, num_subdivisions=6, device="cpu") is tm
    _mesh_agrees(tm, j.get_helicity_band_mesh(band_width=0.01, num_subdivisions=6))
    # Without a "Helicity" attribute the selected one twists the band.
    _mesh_agrees(
        t.get_helicity_band_mesh(num_subdivisions=4, helicity_attribute="h", device="cpu"),
        j.get_helicity_band_mesh(num_subdivisions=4, helicity_attribute="h"))


def test_stress_bands_golden_through_the_port(tmp_path):
    """tests/golden_scenes.py:scene_stress_bands on the port: the
    EIGENVALUE_RATIO band mesh of the synthetic v3 file through
    render_opaque_image at 64x48."""
    tp, _ = _v3_file(tmp_path)
    ld = LineDataStress.load_from_dat([tp], version=3)
    ld.set_band_render_mode("EIGENVALUE_RATIO")
    mesh = ld.get_band_tube_mesh(band_width=0.012, num_subdivisions=8, device="cpu")
    w, h = golden_scenes.SMALL_SIZE
    s = golden_scenes._settings(w, h)
    img = render_opaque_image(
        mesh, Camera(position=(0.45, 0.25, 0.6), width=w, height=h),
        settings=RasterSettings(width=w, height=h, tile_w=s.tile_w, tile_h=s.tile_h,
                                chunk=s.chunk, span_x=s.span_x, span_y=s.span_y,
                                depth_cue_strength=s.depth_cue_strength))
    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


@pytest.fixture(scope="module")
def femur():
    """Config 4's line data built by each package (synth_v3_blocks of
    np.random.default_rng(11), written and read back)."""
    from tests.baseline_scenes import _femur_line_data

    return femur_line_data(), _femur_line_data()


def test_femur_line_data_matches_jax(femur):
    t, j = femur
    assert t.num_lines == 72 and t.trajectories.max_points == 48
    assert t.line_width == j.line_width == 0.012
    _stress_equal(t, j)


@pytest.mark.parametrize("mode", ["Multi-Layer Alpha Blending", "Moment-Based OIT"])
def test_femur_registry_frame_matches_jax(femur, mode):
    """A small config-4 frame (opacity 0.45, the baseline camera) through
    both registries."""
    from linevis_tpu.render.camera import Camera as JCamera

    t, j = femur
    w, h = golden_scenes.SMALL_SIZE
    cam_kw = dict(position=(0.0, 0.1, 1.2), look_at_point=(0.0, 0.0, 0.0), width=w, height=h)
    jr = jrenderer.create_renderer(mode, JSettingsMap({"opacity": 0.45}))
    jr.set_line_data(j)
    jimg = np.asarray(jr.render(JCamera(**cam_kw)))
    r = trenderer.create_renderer(mode, SettingsMap({"opacity": 0.45}), device="cpu")
    r.set_line_data(t)
    img = r.render(Camera(**cam_kw))
    assert img.shape == jimg.shape == (h, w, 4) and np.isfinite(img).all()
    assert (img[..., 3] > 0).mean() > 0.05
    assert ssim(img[..., :3], jimg[..., :3]) >= 0.999
    assert np.abs(img - jimg).mean() <= 2e-3
