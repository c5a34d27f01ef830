"""linevis_tpu_torch surface meshes vs the JAX package on the CPU.

The same files and numpy inputs go through the JAX package and the port.
Bars:
- the loaders (`loaders/mesh_loader.py`: .obj fan triangulation, binary
  and ASCII STL with the weld; `compute_vertex_normals`,
  `compute_curvature_attribute`; `loaders/hex_mesh.py`) and the stress
  hull's surface: every array identical;
- `surface_vertex_stage` and `build_payload`: 1e-5 relative to each row's
  largest magnitude (the projections' dot products round differently);
  triangle validity exactly;
- B3's plain version against the JAX kernel in interpret mode on the same
  surface CSR at tile 16x8: the bars of tests/test_torch_triangles.py (ids
  on >= 99.9% of pixels, depth and planes within 2 ulp of their terms'
  magnitude where the ids agree);
- whole frames (the registry's cube, the hull pass) at SSIM >= 0.999 and
  mean abs <= 2e-3 against the JAX package, and the checked-in golden
  `surface_cube.png` at the golden harness's bar (SSIM >= 0.99, mean
  difference <= 2e-3);
- the binning window (`surface_span`) equal to the JAX renderer's on
  several cameras and on both sides of an integer extent (1e-4 of the
  scale away from it: the port's float32 w row is a matrix product where
  numpy's is a dot product, so they may differ by an ulp).
Three JAX interpret-mode calls: the cube frame, the hull frame, the B3
kernel.
"""

import dataclasses
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.render_stress_bands import synth_v3_blocks as jsynth
from linevis_tpu.kernels import raster_pallas as jrp
from linevis_tpu.loaders import hex_mesh as jhex
from linevis_tpu.loaders import mesh_loader as jml
from linevis_tpu.loaders.stress_dat import SimulationMeshHull as JHull
from linevis_tpu.loaders.stress_dat import write_stress_trajectories_dat_v3 as jwrite_v3
from linevis_tpu.render import pipeline as jpl
from linevis_tpu.render import surface as jsurf
from linevis_tpu.render.camera import Camera as JCamera
from linevis_tpu.scene import triangle_mesh_data as jtmd
from linevis_tpu.scene.line_data_stress import LineDataStress as JLineDataStress
from linevis_tpu_torch.entry import displaced_icosphere, write_binary_stl
from linevis_tpu_torch.kernels import raster_pallas as trp
from linevis_tpu_torch.loaders import hex_mesh as thex
from linevis_tpu_torch.loaders import mesh_loader as tml
from linevis_tpu_torch.render import pipeline as tpl
from linevis_tpu_torch.render import renderer as trenderer
from linevis_tpu_torch.render import surface as tsurf
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.scene.line_data_stress import LineDataStress
from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData, TriangleMeshRenderer

from tests.test_torch_triangles import ULP2, _term_magnitude, _to_jax

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "surface_cube.png")


def _cube_obj(path):
    """tests/test_surface.py's unit cube .obj with quads (fan triangulation)."""
    v = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    faces = [(1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5), (3, 4, 8, 7), (2, 3, 7, 6), (1, 5, 8, 4)]
    with open(path, "w") as f:
        for p in v:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for q in faces:
            f.write("f " + " ".join(map(str, q)) + "\n")


def _mesh_equal(t, j):
    for name in ("vertices", "triangles", "normals", "attributes"):
        a, b = getattr(t, name), getattr(j, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _cube_camera(cls):
    return cls(position=(0.8, 0.6, 1.2), look_at_point=(0, 0, 0), width=64, height=48)


def test_obj_surface_loader(tmp_path):
    path = str(tmp_path / "cube.obj")
    _cube_obj(path)
    mesh = tml.load_surface_mesh(path)
    _mesh_equal(mesh, jml.load_surface_mesh(path))
    assert mesh.vertices.shape == (8, 3) and mesh.triangles.shape == (12, 3)
    assert (np.sum(mesh.normals * mesh.vertices, axis=1) > 0).all()
    assert mesh.attributes.shape == (8,) and np.isfinite(mesh.attributes).all()
    # An .obj with per-vertex normals keeps them; negative indices count back.
    path2 = str(tmp_path / "tri.obj")
    with open(path2, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nvn 0 0 1\nvn 0 0 1\nf -3 -2 -1\n")
    _mesh_equal(tml.load_surface_mesh(path2), jml.load_surface_mesh(path2))
    with pytest.raises(ValueError):
        tml.load_surface_mesh(str(tmp_path / "mesh.ply"))


def test_stl_roundtrip(tmp_path):
    # tests/test_surface.py's two-triangle binary STL, and the same as ASCII.
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                     [[0, 0, 0], [0, 1, 0], [0, 0, 1]]], np.float32)
    path = str(tmp_path / "two.stl")
    with open(path, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(tris)))
        for t in tris:
            f.write(np.zeros(3, np.float32).tobytes())
            f.write(t.astype("<f4").tobytes())
            f.write(struct.pack("<H", 0))
    mesh = tml.load_surface_mesh(path)
    _mesh_equal(mesh, jml.load_surface_mesh(path))
    assert mesh.triangles.shape == (2, 3) and mesh.vertices.shape[0] == 4
    ascii_path = str(tmp_path / "two_ascii.stl")
    with open(ascii_path, "w") as f:
        f.write("solid two\n")
        for t in tris:
            f.write("facet normal 0 0 0\nouter loop\n")
            for p in t:
                f.write(f"vertex {p[0]} {p[1]} {p[2]}\n")
            f.write("endloop\nendfacet\n")
        f.write("endsolid two\n")
    _mesh_equal(tml.load_surface_mesh(ascii_path), mesh)


@pytest.fixture(scope="module")
def sphere_stl(tmp_path_factory):
    """`displaced_icosphere(3)` (1280 triangles) as a binary STL."""
    path = str(tmp_path_factory.mktemp("sphere") / "sphere.stl")
    write_binary_stl(path, displaced_icosphere(3))
    return path


def test_normals_and_curvature_match_jax(sphere_stl):
    """The weld, the area-weighted normals and the curvature attribute of a
    closed displaced sphere, bit for bit, and through TriangleMeshData's
    normalization."""
    t, j = tml.load_surface_mesh(sphere_stl), jml.load_surface_mesh(sphere_stl)
    _mesh_equal(t, j)
    assert t.vertices.shape == (642, 3) and t.triangles.shape == (1280, 3)
    assert 0.1 < float(np.median(t.attributes)) < 0.9 and t.attributes.max() == 1.0
    n = tml.compute_vertex_normals(t.vertices, t.triangles)
    np.testing.assert_array_equal(n, jml.compute_vertex_normals(j.vertices, j.triangles))
    _mesh_equal(TriangleMeshData.load_from_file(sphere_stl).mesh,
                jtmd.TriangleMeshData.load_from_file(sphere_stl).mesh)


def test_hex_mesh_boundary_extraction(tmp_path):
    """tests/test_surface.py's 2x1x1 hex block (10 boundary quads, the
    shared face culled) through both packages."""
    pts = np.array([(x, y, z) for x in (0, 1, 2) for z in (0, 1) for y in (0, 1)], np.float32)

    def pid(x, y, z):
        return x * 4 + z * 2 + y

    def hex_cell(x0):
        return [pid(x0, 0, 0), pid(x0 + 1, 0, 0), pid(x0 + 1, 1, 0), pid(x0, 1, 0),
                pid(x0, 0, 1), pid(x0 + 1, 0, 1), pid(x0 + 1, 1, 1), pid(x0, 1, 1)]

    path = str(tmp_path / "block.vtk")
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nhex\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {len(pts)} float\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        f.write("CELLS 2 18\n")
        for c in (hex_cell(0), hex_cell(1)):
            f.write("8 " + " ".join(map(str, c)) + "\n")
        f.write("CELL_TYPES 2\n12\n12\n")
    hull = thex.load_hull_from_hex_mesh(path)
    _mesh_equal(hull, jhex.load_hull_from_hex_mesh(path))
    assert hull.triangles.shape[0] == 20
    t = hull.triangles
    edges = np.sort(np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]]), axis=1)
    assert (np.unique(edges, axis=0, return_counts=True)[1] == 2).all()
    points, hexes = thex.load_hex_mesh_vtk(path)
    assert points.dtype == np.float32 and hexes.dtype == np.int64 and hexes.shape == (2, 8)


def _image_bars(t_img, j_img):
    assert t_img.shape == j_img.shape and np.isfinite(t_img).all()
    assert ssim(t_img[..., :3], j_img[..., :3]) >= 0.999
    assert np.abs(t_img - j_img).mean() <= 2e-3


def test_surface_render_cube_matches_jax_and_golden(tmp_path):
    """tests/test_surface.py's cube through both registries' "Opaque
    (Triangle Mesh)" renderers: the image of tests/golden_scenes.py's
    scene_surface_cube, so also the golden."""
    path = str(tmp_path / "cube.obj")
    _cube_obj(path)
    r = trenderer.create_renderer("Opaque (Triangle Mesh)", device="cpu")
    assert isinstance(r, TriangleMeshRenderer) and r.device.type == "cpu"
    r.set_line_data(TriangleMeshData.load_from_file(path))
    img = r.render(_cube_camera(Camera))
    jr = jtmd.TriangleMeshRenderer()
    jr.set_line_data(jtmd.TriangleMeshData.load_from_file(path))
    _image_bars(img, jr.render(_cube_camera(JCamera)))
    # tests/test_surface.py's checks on the port's frame.
    fg = (img[..., :3] < 0.999).any(-1)
    assert fg[24, 32] and not fg[0, 0]
    assert img[..., :3].mean(-1)[fg].std() > 0.01
    golden = np.asarray(load_png(GOLDEN), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def _hull_blocks_and_hull():
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
    return (jsynth(np.random.default_rng(1), lines_per_ps=2, n=8),
            JHull(vertices=verts, triangles=np.array(tris, np.int32)))


def test_stress_hull_surface_matches_jax(tmp_path):
    """tests/test_surface.py's hull pass (a v3 .dat with an 8-gon prism
    hull, the hull TF at alpha 0.3, span 3x4) through both packages."""
    path = str(tmp_path / "psl.dat")
    blocks, hull = _hull_blocks_and_hull()
    jwrite_v3(path, blocks, hull)
    ld = LineDataStress.load_from_dat([path], version=3)
    surf = ld.get_hull_surface()
    assert ld.get_hull_surface() is surf  # cached
    _mesh_equal(surf, JLineDataStress.load_from_dat([path], version=3).get_hull_surface())
    assert np.isfinite(surf.normals).all()

    def settings(cls, stress_cls):
        return cls(width=48, height=32, tile_w=16, tile_h=8, span_x=3, span_y=4,
                   tf_color=((0.0,) + stress_cls.HULL_COLOR_LINEAR,
                             (1.0,) + stress_cls.HULL_COLOR_LINEAR),
                   tf_opacity=((0.0, stress_cls.HULL_OPACITY), (1.0, stress_cls.HULL_OPACITY)))

    cam = dict(position=(0.7, 0.4, 1.0), look_at_point=(0, 0, 0), width=48, height=32)
    img = tsurf.render_surface_image(surf, Camera(**cam),
                                     settings=settings(tpl.RasterSettings, LineDataStress),
                                     device="cpu")
    _image_bars(img, jsurf.render_surface_image(
        surf, JCamera(**cam), settings=settings(jpl.RasterSettings, JLineDataStress)))
    assert (img[..., 3] != 1.0).any()  # alpha 0.3 where the hull covers
    # Without a hull there is no surface.
    plain = str(tmp_path / "psl_plain.dat")
    jwrite_v3(plain, blocks, None)
    assert LineDataStress.load_from_dat([plain], version=3).get_hull_surface() is None


def _sphere_tensors(path):
    d = TriangleMeshData.load_from_file(path)
    return d, d.get_surface_tensors("cpu")


def _jax_batch(mesh, vp, W, H):
    return jsurf._surface_vertex_stage(
        jnp.asarray(mesh.vertices.numpy()), jnp.asarray(mesh.normals.numpy()),
        jnp.asarray(mesh.attributes.numpy()), jnp.asarray(mesh.triangles.numpy().astype(np.int32)),
        jnp.asarray(vp), W, H)


def _rel_close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.maximum(np.abs(b).reshape(b.shape[0], -1).max(axis=1), 1e-30)
    err = np.abs(a - b).reshape(b.shape[0], -1).max(axis=1)
    assert (err <= tol * scale).all(), (err / scale).max()


def test_surface_vertex_stage_and_payload_match_jax(sphere_stl):
    _, mesh = _sphere_tensors(sphere_stl)
    W, H = 96, 64
    vp = Camera(position=(0.3, 0.5, 1.1), look_at_point=(0, 0, 0), width=W,
                height=H).view_projection_matrix()
    tb = tsurf.surface_vertex_stage(mesh.vertices, mesh.normals, mesh.attributes,
                                    mesh.triangles, torch.tensor(vp), W, H)
    jb = _jax_batch(mesh, vp, W, H)
    for f in ("tri_x", "tri_y", "tri_z", "corner_inv_w", "corner_attr"):
        _rel_close(getattr(tb, f).numpy(), getattr(jb, f))
    for a, b in zip(tb.corner_normal, jb.corner_normal):
        _rel_close(a.numpy(), b)
    assert all(not c.any() for c in tb.corner_tangent)
    np.testing.assert_array_equal(tb.tri_valid.numpy(), np.asarray(jb.tri_valid))
    np.testing.assert_allclose(float(tb.view_z_min), float(jb.view_z_min), rtol=1e-6)
    np.testing.assert_allclose(float(tb.view_z_max), float(jb.view_z_max), rtol=1e-6)
    same = tpl.TriangleBatch(**{
        f.name: (tuple(torch.tensor(np.asarray(c)) for c in getattr(jb, f.name))
                 if isinstance(getattr(jb, f.name), tuple)
                 else torch.tensor(np.asarray(getattr(jb, f.name))))
        for f in dataclasses.fields(jb)
    })
    jp, tp = np.asarray(jpl.build_payload(jb)), tpl.build_payload(same).numpy()
    np.testing.assert_array_equal(tp[12:16], jp[12:16])
    _rel_close(tp, jp)


def test_surface_raster_reference_matches_pallas(sphere_stl):
    """B3's plain version on the sphere frame's CSR (tile 16x8, the span of
    `surface_span`: sub-pixel and multi-tile triangles in one CSR) against
    the JAX kernel in interpret mode on the same arrays."""
    data, mesh = _sphere_tensors(sphere_stl)
    cam = Camera(position=(0.2, 0.3, 0.9), look_at_point=(0, 0, 0), width=80, height=48)
    r = TriangleMeshRenderer(device="cpu")
    r.set_line_data(data)
    S = r.raster_settings(cam)
    assert (S.tile_w, S.tile_h) == (16, 8) and S.span_x >= 3
    batch, csr = tsurf.surface_frame(mesh, torch.tensor(cam.view_projection_matrix()), S)
    assert int(csr.overflow) == 0 and int(csr.tile_num_chunks.max()) >= 1
    jz, jid, jg = jrp.rasterize_gbuffer_pallas(_to_jax(csr), 8, 16, 8, interpret=True)
    tz, tid, tg = trp.rasterize_gbuffer(csr, 8, 16, 8)
    jz, jid, tz, tid = np.asarray(jz), np.asarray(jid), tz.numpy(), tid.numpy()
    agree = jid == tid
    assert agree.mean() >= 0.999
    hit = agree & (tid >= 0)
    assert hit.sum() > 0.1 * hit.size
    miss = agree & (tid < 0)
    assert (tz[miss] == 2.0).all() and (jz[miss] == 2.0).all()
    zmag, mags = _term_magnitude(csr, (16, 8), 8)
    assert (np.abs(jz - tz)[hit] <= ULP2 * zmag[hit]).all()
    for a, b, m in zip(jg, tg, mags):
        assert (np.abs(np.asarray(a) - b.numpy())[hit] <= ULP2 * m[hit]).all()


def _jax_span(mesh_np, cam_kw, monkeypatch):
    """The JAX registry renderer's span for this camera (its render with
    render_surface_image replaced by a recorder of the settings)."""
    seen = {}

    def record(mesh, camera, tf=None, settings=None):
        seen["span"] = (settings.span_x, settings.span_y)
        return None

    monkeypatch.setattr(jsurf, "render_surface_image", record)
    jr = jtmd.TriangleMeshRenderer()
    jr.set_line_data(jtmd.TriangleMeshData(jml.SurfaceMesh(**mesh_np)))
    jr.render(JCamera(**cam_kw))
    return seen["span"]


def _port_span(mesh_np, cam_kw):
    d = TriangleMeshData(tml.SurfaceMesh(**mesh_np))
    r = TriangleMeshRenderer(device="cpu")
    r.set_line_data(d)
    s = r.raster_settings(Camera(**cam_kw))
    return s.span_x, s.span_y


def _numpy_extent(mesh_np, cam_kw):
    """The largest front triangle's x extent in 16-pixel tiles, as the JAX
    renderer computes it."""
    cam = JCamera(**cam_kw)
    vp = np.asarray(cam.view_projection_matrix())
    v, t = mesh_np["vertices"], mesh_np["triangles"]
    clip = v @ vp[:3, :3].T + vp[:3, 3]
    w = v @ vp[3, :3] + vp[3, 3]
    w = np.where(np.abs(w) < 1e-4, 1e-4, w)
    sx = np.clip((clip[:, 0] / w * 0.5 + 0.5) * cam.width, -cam.width, 2 * cam.width)
    return float(((sx[t].max(1) - sx[t].min(1)) / 16)[(w[t] > 0).all(1)].max())


def test_surface_span_matches_jax(sphere_stl, monkeypatch):
    m = tml.load_surface_mesh(sphere_stl)
    sphere = dict(vertices=m.vertices * np.float32(0.5), triangles=m.triangles,
                  normals=m.normals, attributes=m.attributes)
    cams = [dict(position=p, look_at_point=(0, 0, 0), width=w, height=h)
            for p, w, h in (((0.2, 0.3, 0.9), 80, 48), ((1.5, 0.2, 0.1), 333, 200),
                            ((0.0, 0.05, 0.55), 640, 360), ((0.01, 0.0, 0.3), 160, 96))]
    spans = []
    for c in cams:
        spans.append(_port_span(sphere, c))
        assert spans[-1] == _jax_span(sphere, c, monkeypatch)
    assert len(set(spans)) > 1
    # One big triangle scaled to either side of an extent of exactly 3
    # tiles (found by bisection on the JAX renderer's numpy formula).
    cam = dict(position=(0.1, 0.2, 2.0), look_at_point=(0, 0, 0), width=200, height=120)
    tri = np.array([[-0.3, -0.2, 0.0], [0.25, -0.1, 0.1], [0.0, 0.3, -0.05]], np.float32)

    def mesh_at(s):
        return dict(vertices=(tri * np.float32(s)).astype(np.float32),
                    triangles=np.array([[0, 1, 2]], np.int32),
                    normals=np.tile(np.float32([0, 0, 1]), (3, 1)),
                    attributes=np.zeros(3, np.float32))

    lo, hi = 0.01, 10.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if _numpy_extent(mesh_at(mid), cam) < 3.0 else (lo, mid)
    for s in (lo * (1 - 1e-4), hi * (1 + 1e-4)):
        assert _port_span(mesh_at(s), cam) == _jax_span(mesh_at(s), cam, monkeypatch)
    assert _port_span(mesh_at(lo * (1 - 1e-4)), cam)[0] == 5
    assert _port_span(mesh_at(hi * (1 + 1e-4)), cam)[0] == 6
    # Nothing in front of the camera: 2 x 2.
    behind = dict(cam, position=(0.0, 0.0, -2.0), look_at_point=(0.0, 0.0, -3.0))
    assert _port_span(sphere, behind) == _jax_span(sphere, behind, monkeypatch) == (2, 2)


def test_triangle_mesh_mode_by_name_and_device(sphere_stl):
    assert "Opaque (Triangle Mesh)" in trenderer.RENDERING_MODE_ALL
    assert "Opaque (Triangle Mesh)" not in trenderer.UNPORTED_MODES
    r = trenderer.create_renderer("Opaque (Triangle Mesh)")
    assert r.device.type == "cuda" and r.name == "Opaque (Triangle Mesh)"  # the default
    data, mesh = _sphere_tensors(sphere_stl)
    assert data.get_surface_tensors("cpu") is mesh  # cached per device
    data.mark_dirty()
    assert data.get_surface_tensors("cpu") is not mesh and not data.dirty
    r = trenderer.create_renderer("Opaque (Triangle Mesh)", device="cpu")
    r.set_line_data(data)
    launches = trp.rasterize_gbuffer.launches
    img = r.render(Camera(position=(0.2, 0.3, 0.9), look_at_point=(0, 0, 0), width=64,
                          height=48))
    assert trp.rasterize_gbuffer.launches == launches  # CPU: the plain version
    assert img.shape == (48, 64, 4) and np.isfinite(img).all()
    fg = (img[..., :3] < 0.999).any(-1)
    assert 0.3 < fg.mean() < 1.0
    # depth_cue_strength through set_new_settings, as in JAX.
    from linevis_tpu_torch.core.settings import SettingsMap

    r.set_new_settings(SettingsMap({"depth_cue_strength": 0.5}))
    assert r.raster_settings(Camera(width=32, height=16)).depth_cue_strength == 0.5
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            data.get_surface_tensors("cuda")
