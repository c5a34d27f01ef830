"""linevis_tpu_torch dataset loaders and the scene factory vs the JAX package on the CPU.

The flow and mesh cases of tests/test_loaders.py, tests/test_native.py and
tests/test_scene_api.py::test_load_line_data_factory on the port: the same
files go through both packages and every array comes out identical
(positions, attributes, masks, names, meshes, degenerate points; the
writers' bytes equal). The port's .obj Python fallback converts its vertex
list once instead of at every `l` line; its output stays equal to the JAX
fallback's and to the native parser's. The NetCDF-4 (HDF5) branch runs
where h5py is installed and skips elsewhere, as the JAX module needs it.
"""

import dataclasses
import filecmp
import json

import numpy as np
import pytest

from examples.render_stress_bands import synth_v3_blocks as jsynth
from linevis_tpu import native as jnative
from linevis_tpu.core.trajectories import RaggedTrajectories as JRagged
from linevis_tpu.loaders import binlines as jbin
from linevis_tpu.loaders import dataset_list as jdl
from linevis_tpu.loaders import flow_file as jflow
from linevis_tpu.loaders import netcdf_lines as jnc
from linevis_tpu.loaders import obj_loader as jobj
from linevis_tpu.loaders.stress_dat import SimulationMeshHull as JHull
from linevis_tpu.loaders.stress_dat import write_stress_trajectories_dat_v3 as jwrite_v3
from linevis_tpu.scene import factory as jfactory
from linevis_tpu_torch import native as tnative
from linevis_tpu_torch.core.trajectories import RaggedTrajectories
from linevis_tpu_torch.core.transforms import parse_transform_string
from linevis_tpu_torch.loaders import binlines as tbin
from linevis_tpu_torch.loaders import dataset_list as tdl
from linevis_tpu_torch.loaders import flow_file as tflow
from linevis_tpu_torch.loaders import netcdf_lines as tnc
from linevis_tpu_torch.loaders import obj_loader as tobj
from linevis_tpu_torch.scene import factory as tfactory
from linevis_tpu_torch.scene.line_data import LineDataFlow
from linevis_tpu_torch.scene.line_data_stress import LineDataStress
from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData

OBJ_TEXT = (
    "# comment\n"
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 5\nv 1e20 0 0\n"
    "vt 0.1\nvt 0.2\nvt 0.3\nvt 0.4\nvt 0.5\n"
    "a speed\n"
    "g line0\n"
    "l 1 2 3\n"
    "l 3 4 5\n"
)


def _ragged_equal(t, j):
    assert t.num_lines == j.num_lines and t.attribute_names == j.attribute_names
    for a, b in zip(t.positions + t.attributes, j.positions + j.attributes):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _traj_equal(t, j):
    for f in ("positions", "attributes", "mask", "num_points"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.attribute_names == j.attribute_names


def _python_obj(module, native_module, path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native_module, "available", lambda: False)
        return module.load_trajectories_from_obj(path)


def test_obj_loader(tmp_path, monkeypatch):
    # tests/test_loaders.py test_obj_loader / test_obj_invalid_points_dropped.
    obj = tmp_path / "lines.obj"
    obj.write_text(OBJ_TEXT)
    t = tobj.load_trajectories_from_obj(str(obj))
    _ragged_equal(t, jobj.load_trajectories_from_obj(str(obj)))
    assert t.attribute_names == ["speed"]
    np.testing.assert_allclose(t.positions[0], [[0, 0, 0], [1, 0, 0], [1, 1, 0]])
    np.testing.assert_allclose(t.positions[1], [[1, 1, 0], [0, 1, 5]])  # 1e20 dropped
    np.testing.assert_allclose(t.attributes[0][0], [0.1, 0.2, 0.3], rtol=1e-6)
    _ragged_equal(_python_obj(tobj, tnative, str(obj), monkeypatch),
                  _python_obj(jobj, jnative, str(obj), monkeypatch))


def test_obj_python_fallback_matches_jax_and_native(tmp_path, monkeypatch):
    """A file whose `l` lines interleave with new vertices and attributes:
    the port's fallback converts its lists only when they grew; its lines
    equal the JAX fallback's and the native parser's."""
    rng = np.random.default_rng(3)
    lines, n_v = [], 0
    for li in range(12):
        n = int(rng.integers(2, 9))
        for p in rng.normal(size=(n, 3)).astype(np.float32):
            lines.append(f"v {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}")
        for a in rng.uniform(size=(n, 2)).astype(np.float32):
            lines.append(f"vt {a[0]:.9g} {a[1]:.9g}")
        idx = rng.integers(1, n_v + n + 1, size=n) if li % 3 else np.arange(n_v + 1, n_v + n + 1)
        lines.append("l " + " ".join(map(str, idx)))
        n_v += n
    obj = tmp_path / "mixed.obj"
    obj.write_text("a u v\n" + "\n".join(lines) + "\n")
    t_py = _python_obj(tobj, tnative, str(obj), monkeypatch)
    _ragged_equal(t_py, _python_obj(jobj, jnative, str(obj), monkeypatch))
    nat = tobj.load_trajectories_from_obj(str(obj))
    assert nat.num_lines == t_py.num_lines == 12
    for a, b in zip(nat.positions + nat.attributes, t_py.positions + t_py.attributes):
        np.testing.assert_array_equal(a, b)


def test_native_matches_jax_native_and_python(tmp_path, monkeypatch):
    # tests/test_native.py on the port's own build of native/loaders.cpp.
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.exists() and lib.parent.name == "build"
    f = tmp_path / "vals.dat"
    f.write_text("major 3\n1.5 2.5\n-3e-2\n")
    np.testing.assert_allclose(tnative.parse_floats(str(f)), [3.0, 1.5, 2.5, -0.03])
    obj = tmp_path / "lines.obj"
    obj.write_text(OBJ_TEXT)
    positions, attributes, names = tnative.parse_obj(str(obj))
    assert names == ["speed"] and len(positions) == 2
    if jnative.available():
        np.testing.assert_array_equal(tnative.parse_floats(str(f)), jnative.parse_floats(str(f)))
        jp, ja, jn = jnative.parse_obj(str(obj))
        assert jn == names
        for a, b in zip(positions + attributes, jp + ja):
            np.testing.assert_array_equal(a, b)
    py = _python_obj(tobj, tnative, str(obj), monkeypatch)
    for a, b in zip(positions + attributes, py.positions + py.attributes):
        np.testing.assert_allclose(a, b)
    # Without a compiler or library the callers fall back to Python.
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_failed", True)
    assert not tnative.available() and tnative.parse_floats(str(f)) is None


def test_binlines_roundtrip_and_bytes(tmp_path):
    rng = np.random.default_rng(0)
    positions = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 9)]
    attributes = [rng.normal(size=(2, n)).astype(np.float32) for n in (5, 9)]
    ribbons = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 9)]
    kw = dict(vertices_normalized=True, ribbon_directions=ribbons,
              mesh_outline_indices=np.arange(6, dtype=np.uint32),
              mesh_outline_positions=rng.normal(size=(4, 3)).astype(np.float32))
    tpath, jpath = str(tmp_path / "t.binlines"), str(tmp_path / "j.binlines")
    tbin.save_trajectories_as_binlines(tpath, tbin.BinLinesData(
        trajectories=RaggedTrajectories(positions, attributes, ["u", "v"]), **kw))
    jbin.save_trajectories_as_binlines(jpath, jbin.BinLinesData(
        trajectories=JRagged(positions, attributes, ["u", "v"]), **kw))
    assert filecmp.cmp(tpath, jpath, shallow=False)
    t, j = tbin.load_trajectories_from_binlines(tpath), jbin.load_trajectories_from_binlines(tpath)
    _ragged_equal(t.trajectories, j.trajectories)
    assert t.vertices_normalized and t.trajectories.attribute_names == ["u", "v"]
    for a, b in zip(t.ribbon_directions, ribbons):
        np.testing.assert_array_equal(a, b)
    for f in ("mesh_outline_indices", "mesh_outline_positions", "mesh_outline_normals"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.binlines"
    bad.write_bytes(np.uint32([7, 0, 0]).tobytes())
    with pytest.raises(ValueError):
        tbin.load_trajectories_from_binlines(str(bad))


def _write_netcdf(path, rng, n_traj=3, n_time=10):
    """tests/test_loaders.py's CF-style trajectory file (scipy, classic)."""
    from scipy.io import netcdf_file

    lon = rng.uniform(-0.4, 0.4, (1, n_traj, n_time)).astype(np.float32)
    lat = rng.uniform(-0.4, 0.4, (1, n_traj, n_time)).astype(np.float32)
    pressure = rng.uniform(100.0, 1000.0, (1, n_traj, n_time)).astype(np.float32)
    pressure[0, 1, 7:] = np.nan
    pressure[0, 2, :2] = -1.0
    extra = rng.uniform(0, 1, (1, n_traj, n_time)).astype(np.float32)
    f = netcdf_file(path, "w")
    f.createDimension("ensemble", 1)
    f.createDimension("trajectory", n_traj)
    f.createDimension("time", n_time)
    dims = ("ensemble", "trajectory", "time")
    for name, data in [("lon", lon), ("lat", lat), ("pressure", pressure), ("vorticity", extra)]:
        v = f.createVariable(name, "f", dims)
        v[:] = data
    f.variables["vorticity"].standard_name = "Vorticity"
    f.close()
    return dict(lon=lon, lat=lat, pressure=pressure, vorticity=extra)


def test_netcdf_trajectories_match_jax(tmp_path):
    path = str(tmp_path / "traj.nc")
    _write_netcdf(path, np.random.default_rng(5))
    t = tnc.load_trajectories_from_netcdf(path)
    _ragged_equal(t, jnc.load_trajectories_from_netcdf(path))
    assert [p.shape[0] for p in t.positions] == [10, 7, 8]
    assert set(t.attribute_names) == {"pressure", "Vorticity"}
    _traj_equal(tflow.load_flow_trajectories_from_file(path),
                jflow.load_flow_trajectories_from_file(path))


def test_netcdf4_hdf5_branch_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(6)
    path = str(tmp_path / "traj4.nc")
    with h5py.File(path, "w") as f:
        for name in ("lon", "lat", "vorticity"):
            f.create_dataset(name, data=rng.uniform(-0.4, 0.4, (1, 2, 6)).astype(np.float32))
        p = rng.uniform(100.0, 1000.0, (1, 2, 6)).astype(np.float32)
        p[0, 0, 4:] = np.nan
        f.create_dataset("pressure", data=p)
        f["vorticity"].attrs["standard_name"] = "Vorticity"
    t = tnc.load_trajectories_from_netcdf(path)
    _ragged_equal(t, jnc.load_trajectories_from_netcdf(path))
    assert [q.shape[0] for q in t.positions] == [4, 6]


def test_flow_file_dispatch_and_normalize(tmp_path):
    # tests/test_loaders.py test_flow_file_dispatch_and_normalize, with a
    # transform, and every extension.
    obj = tmp_path / "lines.obj"
    obj.write_text("v 0 0 0\nv 10 0 0\nv 10 10 0\nvt 5\nvt 10\nvt 15\nl 1 2 3\n")
    traj = tflow.load_flow_trajectories_from_file(str(obj))
    _traj_equal(traj, jflow.load_flow_trajectories_from_file(str(obj)))
    assert np.abs(traj.positions[traj.mask]).max() <= 0.5 + 1e-6
    a = traj.attributes[0, 0][traj.mask[0]]
    assert a.min() == 0.0 and a.max() == 1.0 and traj.attribute_names == ["Attribute #1"]
    m = parse_transform_string("rotate(90°, 0, 1, 0) scale(2)")
    _traj_equal(tflow.load_flow_trajectories_from_file(str(obj), transform=m, max_points=8),
                jflow.load_flow_trajectories_from_file(str(obj), transform=m, max_points=8))
    with pytest.raises(ValueError):
        tflow.load_flow_trajectories_from_file(str(tmp_path / "lines.vtk"))


def test_dataset_list_matches_jax(tmp_path):
    # tests/test_loaders.py test_dataset_list, with every optional key.
    doc = {"datasets": [{"type": "node", "name": "group", "children": [
        {"type": "flow", "name": "tornado", "filenames": "tornado.obj", "linewidth": 0.004,
         "attributes": ["speed"], "transform": "translate(1, 2, 3)", "heightscale": 2.0},
        {"type": "stress", "name": "femur", "filenames": ["a.dat", "b.dat"], "version": 3,
         "mesh": "hull.vtk", "degenerate_points": "degen.dat",
         "line_hierarchy": "levels.dat"},
        {"type": "trimesh", "name": "bunny", "filenames": "/abs/bunny.stl"},
    ]}]}
    path = tmp_path / "datasets.json"
    path.write_text(json.dumps(doc))
    t, j = tdl.load_dataset_list(str(path)), jdl.load_dataset_list(str(path))
    tl, jl = t.flat_leaves(), j.flat_leaves()
    assert [x.name for x in tl] == ["tornado", "femur", "bunny"]
    for a, b in zip(tl, jl):
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(vb, np.ndarray):
                np.testing.assert_array_equal(va, vb)
            elif f.name != "children":
                assert va == vb, f.name
    assert len(tl[1].attribute_names) == 9 and tl[1].transform is not None


def _femur_files(tmp_path):
    blocks = jsynth(np.random.default_rng(0), lines_per_ps=2, n=6)
    hull = JHull(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
                 triangles=np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], np.int32))
    jwrite_v3(str(tmp_path / "psl.dat"), blocks, hull)
    (tmp_path / "degen.dat").write_text("2\n0.1 0.2 0.3\n0.4 0.5 0.6\n")


def _compare_loaded(t, j):
    assert type(t).__name__ == type(j).__name__
    if isinstance(t, TriangleMeshData):
        for f in ("vertices", "triangles", "normals", "attributes"):
            np.testing.assert_array_equal(getattr(t.mesh, f), getattr(j.mesh, f))
        return
    _traj_equal(t.trajectories, j.trajectories)
    assert t.attribute_names == j.attribute_names and t.line_width == j.line_width
    if isinstance(t, LineDataStress):
        np.testing.assert_array_equal(t.degenerate_points, j.degenerate_points)
        th, jh = t.get_hull_surface(), j.get_hull_surface()
        for f in ("vertices", "triangles", "normals", "attributes"):
            np.testing.assert_array_equal(getattr(th, f), getattr(jh, f))


def test_load_line_data_factory(tmp_path):
    """tests/test_scene_api.py::test_load_line_data_factory on both
    packages, and a datasets.json naming every file type the JAX package
    reads: flow .obj, .binlines and NetCDF, a v3 stress .dat with a hull and
    degenerate points, .obj and .stl surfaces."""
    (tmp_path / "lines.obj").write_text("v 0 0 0\nv 1 0 0\nv 2 0 0\nvt 0.1\nvt 0.5\nvt 0.9\n"
                                        "l 1 2 3\n")
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    rng = np.random.default_rng(2)
    jbin.save_trajectories_as_binlines(str(tmp_path / "lines.binlines"), jbin.BinLinesData(
        trajectories=JRagged([rng.normal(size=(7, 3)).astype(np.float32)],
                             [rng.uniform(size=(1, 7)).astype(np.float32)], ["speed"])))
    _write_netcdf(str(tmp_path / "traj.nc"), rng)
    _femur_files(tmp_path)
    from linevis_tpu_torch.entry import displaced_icosphere, write_binary_stl

    write_binary_stl(str(tmp_path / "sphere.stl"), displaced_icosphere(1))
    for name, cls in (("lines.obj", LineDataFlow), ("tri.obj", TriangleMeshData),
                      ("lines.binlines", LineDataFlow), ("traj.nc", LineDataFlow),
                      ("psl.dat", LineDataStress), ("sphere.stl", TriangleMeshData)):
        t = tfactory.load_line_data(str(tmp_path / name))
        assert isinstance(t, cls), name
        _compare_loaded(t, jfactory.load_line_data(str(tmp_path / name)))
    with pytest.raises(ValueError):
        tfactory.load_line_data(str(tmp_path / "volume.raw"))

    doc = {"datasets": [
        {"type": "flow", "name": "obj", "filenames": "lines.obj", "linewidth": 0.01,
         "attributes": ["speed"]},
        {"type": "flow", "name": "binlines", "filenames": "lines.binlines"},
        {"type": "flow", "name": "netcdf", "filenames": "traj.nc",
         "transform": "rotate(90°, 1, 0, 0)"},
        {"type": "node", "name": "group", "children": [
            {"type": "stress", "name": "femur", "filenames": "psl.dat", "version": 3,
             "degenerate_points": "degen.dat", "linewidth": 0.01},
            {"type": "trimesh", "name": "sphere", "filenames": "sphere.stl"},
            {"type": "trimesh", "name": "triangle", "filenames": "tri.obj"},
        ]},
    ]}
    (tmp_path / "datasets.json").write_text(json.dumps(doc))
    leaves = tdl.load_dataset_list(str(tmp_path / "datasets.json")).flat_leaves()
    jleaves = jdl.load_dataset_list(str(tmp_path / "datasets.json")).flat_leaves()
    loaded = [tfactory.load_line_data(info) for info in leaves]
    for t, info in zip(loaded, jleaves):
        _compare_loaded(t, jfactory.load_line_data(info))
    assert [type(x).__name__ for x in loaded] == [
        "LineDataFlow", "LineDataFlow", "LineDataFlow", "LineDataStress", "TriangleMeshData",
        "TriangleMeshData"]
    assert loaded[0].line_width == 0.01 and loaded[0].attribute_names[0] == "speed"
    assert loaded[3].degenerate_points.shape == (2, 3) and loaded[3].line_width == 0.01
    assert loaded[3].get_hull_surface().triangles.shape == (4, 3)
    # The base_dir form with bare file names, as test_scene_api.py does.
    info = tdl.DataSetInformation(type=tdl.DATA_SET_TYPE_STRESS_LINES, filenames=["psl.dat"],
                                  version=3, degenerate_points_filename="degen.dat",
                                  line_width=0.01, name="synthetic")
    lds = tfactory.load_line_data(info, base_dir=str(tmp_path))
    assert isinstance(lds, LineDataStress) and lds.degenerate_points.shape == (2, 3)
    with pytest.raises(ValueError):
        tfactory.load_line_data(tdl.DataSetInformation(type="volume", filenames=["x"]))
