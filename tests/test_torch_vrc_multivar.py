"""linevis_tpu_torch's VRC, multivariate tubes, segments, isosurfaces and grid
loaders vs the JAX package on the CPU.

Bars:
- `discretize_curves`: `valid` and the voxel cells equal; the quantized
  endpoints within one float32 ulp of the scene's largest coordinate
  (measured: 66-71% equal, the rest one ulp of that magnitude apart; the
  lattice points cell_lo + k cell / q are sums that XLA's CPU backend
  contracts otherwise); the attributes within 1e-6.
- The goldens `vrc.png` (through the port's registry, B1's plain version)
  and `multivar.png` (through `render_opaque_image`, B3's plain version)
  under the golden gate of tests/test_golden.py:46-50 (SSIM >= 0.99, image
  mean difference <= 2e-3).
- `combine_transfer_functions` and `combine_transfer_function_table` equal
  JAX's; the multivariate mesh's packed attributes within 1e-7.
- `build_line_segments` and `LineData.get_line_segments` equal JAX's.
- `extract_isosurface` equal to JAX's (the same numpy code on a port mesh).
- The grid loader: every format written by the test (VTK legacy ASCII and
  binary, VTK XML ascii, base64 and appended raw, .dat/.raw, AmiraMesh,
  .field, NetCDF) read to arrays equal to JAX's; a wrong-sized RBC .bin and
  GRIB raise as in JAX; one loaded grid traced by the port's grid tracer.
"""

import base64
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linevis_tpu.core.trajectories import Trajectories as JTrajectories
from linevis_tpu.geometry import isosurface as jiso
from linevis_tpu.geometry import segments as jseg
from linevis_tpu.loaders import grid_loader as jgl
from linevis_tpu.render import multivar as jmv
from linevis_tpu.render import vrc as jvrc
from linevis_tpu.render.transfer_function import TransferFunction as JTF
from linevis_tpu_torch.core.trajectories import Trajectories
from linevis_tpu_torch.geometry import isosurface as tiso
from linevis_tpu_torch.geometry import segments as tseg
from linevis_tpu_torch.loaders import grid_loader as tgl
from linevis_tpu_torch.render import multivar as tmv
from linevis_tpu_torch.render import vrc as tvrc
from linevis_tpu_torch.render.camera import Camera
from linevis_tpu_torch.render.framebuffer import (
    image_mean_difference,
    load_png,
    ssim,
    to_srgb_u8,
)
from linevis_tpu_torch.render.opaque import render_opaque_image
from linevis_tpu_torch.render.pipeline import RasterSettings
from linevis_tpu_torch.render.renderer import create_renderer
from linevis_tpu_torch.render.transfer_function import TransferFunction
from linevis_tpu_torch.scene.line_data import LineData

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SMALL = (64, 48)


def _golden_gate(name, img):
    golden = np.asarray(load_png(os.path.join(GOLDEN_DIR, f"{name}.png")), np.float64) / 255.0
    rendered = np.asarray(to_srgb_u8(img), np.float64) / 255.0
    assert rendered.shape == golden.shape
    assert ssim(rendered[..., :3], golden[..., :3]) >= 0.99
    assert image_mean_difference(rendered[..., :3], golden[..., :3]) <= 2e-3


def _vrc_lines(seed=21, L=6, P=8, spread=0.06):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, spread, (L, P, 3)), axis=1).astype(np.float32)
    pos -= pos.mean(axis=(0, 1))
    return dict(positions=pos, attributes=rng.uniform(0, 1, (L, 1, P)).astype(np.float32),
                mask=np.ones((L, P), bool), num_points=np.full((L,), P, np.int32),
                attribute_names=["a"])


@pytest.mark.parametrize("grid_resolution,quantization,span", [(128, 8, 3), (32, 4, 4)])
def test_discretize_curves_equals_jax(grid_resolution, quantization, span):
    d = _vrc_lines(seed=5, L=9, P=12, spread=0.02)
    mask = d["mask"].copy()
    mask[2, 7:] = False
    attrs = d["attributes"][:, 0]
    j = jvrc.discretize_curves(jnp.asarray(d["positions"]), jnp.asarray(mask), jnp.asarray(attrs),
                               grid_resolution=grid_resolution, quantization=quantization,
                               span=span)
    t = tvrc.discretize_curves(torch.as_tensor(d["positions"]), torch.as_tensor(mask),
                               torch.as_tensor(attrs), grid_resolution=grid_resolution,
                               quantization=quantization, span=span)
    jq0, jq1, ja0, ja1, jv = (np.asarray(a) for a in j)
    tq0, tq1, ta0, ta1, tv = (a.numpy() for a in t)
    assert np.array_equal(jv, tv) and tv.sum() > 20
    pos = d["positions"][mask]
    cell = np.maximum(pos.max(0) - pos.min(0), 1e-6) / grid_resolution
    ulp = np.spacing(np.float32(np.abs(pos).max()))
    for jq, tq in ((jq0, tq0), (jq1, tq1)):
        assert np.abs(jq - tq)[:, tv].max() <= ulp
        # The same voxel cell (lower corner) for every valid pair.
        lo = pos.min(0)[:, None]
        cj = np.floor((jq[:, tv] - lo) / cell[:, None] + 1e-3)
        ct = np.floor((tq[:, tv] - lo) / cell[:, None] + 1e-3)
        assert np.array_equal(cj, ct)
    assert np.abs(ja0 - ta0)[tv].max() <= 1e-6 and np.abs(ja1 - ta1)[tv].max() <= 1e-6


def test_vrc_golden_through_the_registry():
    d = _vrc_lines()
    ld = LineData(Trajectories(**d))
    ld.set_line_width(0.04)
    r = create_renderer("Voxel Ray Casting", device="cpu")
    r.set_line_data(ld)
    assert r.device.type == "cpu" and r.quantized_scene().a.device.type == "cpu"
    w, h = SMALL
    _golden_gate("vrc", r.render(Camera(position=(0.0, 0.1, 1.2), look_at_point=(0, 0, 0),
                                        width=w, height=h)))


def _multivar_lines():
    L, P = 3, 6
    pos = np.zeros((L, P, 3), np.float32)
    pos[:, :, 0] = np.linspace(-0.3, 0.3, P)
    for i in range(L):
        pos[i, :, 1] = -0.15 + 0.15 * i
    rng = np.random.default_rng(13)
    a0 = rng.uniform(0, 1, (L, P)).astype(np.float32)
    a1 = rng.uniform(0, 1, (L, P)).astype(np.float32)
    return pos, np.ones((L, P), bool), a0, a1


def test_multivar_golden_and_tables_equal_jax():
    pos, mask, a0, a1 = _multivar_lines()
    jmvt = jmv.MultiVarTransferFunctions([JTF.standard(), JTF.standard()])
    tmvt = tmv.MultiVarTransferFunctions([TransferFunction.standard(),
                                          TransferFunction.standard()])
    assert np.array_equal(jmv.combine_transfer_function_table(jmvt).table,
                          tmv.combine_transfer_function_table(tmvt).table)
    assert jmv.combine_transfer_functions(jmvt) == tmv.combine_transfer_functions(tmvt)
    for K in (1, 3):
        assert (jmv.combine_transfer_functions(jmv.MultiVarTransferFunctions.default(K))
                == tmv.combine_transfer_functions(tmv.MultiVarTransferFunctions.default(K)))
    jm = jmv.build_multivar_tube_mesh(pos, mask, [a0, a1], radius=0.04, num_subdivisions=8)
    tm = tmv.build_multivar_tube_mesh(pos, mask, [a0, a1], radius=0.04, num_subdivisions=8,
                                      device="cpu")
    assert np.abs(np.asarray(jm.attrs) - tm.attrs.numpy()).max() <= 1e-7
    assert np.abs(np.asarray(jm.positions) - tm.positions.numpy()).max() <= 1e-6
    w, h = SMALL
    settings = RasterSettings(width=w, height=h, tile_w=16, tile_h=8, chunk=32, span_x=3,
                              span_y=3, depth_cue_strength=0.2)
    img = render_opaque_image(tm, Camera(position=(0.0, 0.0, 1.2), width=w, height=h),
                              tf=tmv.combine_transfer_function_table(tmvt), settings=settings)
    _golden_gate("multivar", img)


def test_line_segments_equal_jax():
    d = _vrc_lines(seed=3, L=4, P=6)
    d["mask"][1, 4:] = False
    attrs = d["attributes"][:, 0]
    j = jseg.build_line_segments(d["positions"], d["mask"], attrs)
    t = tseg.build_line_segments(d["positions"], d["mask"], attrs, device="cpu")
    for f in dataclasses.fields(tseg.LineSegments):
        assert np.array_equal(np.asarray(getattr(j, f.name)), getattr(t, f.name).numpy()), f.name
    assert t.num_segments == j.num_segments
    for a, b in zip(j.aabbs(0.01), t.aabbs(0.01)):
        assert np.array_equal(np.asarray(a), b.numpy())
    from linevis_tpu.scene.line_data import LineData as JLineData

    jl = JLineData(JTrajectories(**d))
    tl = LineData(Trajectories(**d))
    tl_segs = tl.get_line_segments(device="cpu")
    assert isinstance(tl_segs, tseg.LineSegments)
    assert np.array_equal(np.asarray(jl.get_line_segments().mask), tl_segs.mask.numpy())


def test_extract_isosurface_equals_jax():
    g = np.linspace(-1, 1, 14)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    field = (np.exp(-3 * (xx**2 + yy**2 + zz**2)) + 0.3 * np.exp(-20 * (xx - 0.5) ** 2)
             ).astype(np.float32)
    for iso in (0.4, 0.7):
        j = jiso.extract_isosurface(field, iso, origin=(-1, -1, -1), spacing=(0.1, 0.1, 0.2))
        t = tiso.extract_isosurface(field, iso, origin=(-1, -1, -1), spacing=(0.1, 0.1, 0.2))
        for f in ("vertices", "triangles", "normals", "attributes"):
            assert np.array_equal(getattr(j, f), getattr(t, f)), f
        assert t.triangles.shape[0] > 100
    assert tiso.extract_isosurface(field, 5.0).triangles.shape == (0, 3)


def _grid_equal(path):
    a, b = jgl.load_grid_file(str(path)), tgl.load_grid_file(str(path))
    assert np.array_equal(a.velocity, b.velocity) and a.velocity.dtype == b.velocity.dtype
    assert np.array_equal(a.origin, b.origin) and np.array_equal(a.spacing, b.spacing)
    assert sorted(a.scalars) == sorted(b.scalars)
    for k in a.scalars:
        assert np.array_equal(a.scalars[k], b.scalars[k])
    return b


def test_grid_loader_formats_equal_jax(tmp_path):
    from scipy.io import netcdf_file

    rng = np.random.default_rng(0)
    nx, ny, nz = 5, 4, 3
    n = nx * ny * nz
    vel = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scal = rng.uniform(0, 1, n).astype(np.float32)
    head = (f"DATASET STRUCTURED_POINTS\nDIMENSIONS {nx} {ny} {nz}\nORIGIN 0 1 2\n"
            f"SPACING 0.5 0.5 0.25\nPOINT_DATA {n}\nVECTORS velocity float\n")
    p = tmp_path / "a.vtk"
    p.write_text("# vtk DataFile Version 3.0\nt\nASCII\n" + head
                 + "\n".join(" ".join(map(str, v)) for v in vel)
                 + "\nSCALARS s float 1\nLOOKUP_TABLE default\n" + "\n".join(map(str, scal)))
    g = _grid_equal(p)
    p = tmp_path / "b.vtk"
    p.write_bytes(b"# vtk DataFile Version 3.0\nt\nBINARY\n" + head.encode()
                  + vel.astype(">f4").tobytes()
                  + b"\nSCALARS s float 1\nLOOKUP_TABLE default\n" + scal.astype(">f4").tobytes())
    _grid_equal(p)
    # VTK XML: ascii, inline base64, appended raw.
    blob = np.asarray([vel.nbytes], "<u4").tobytes() + vel.tobytes()
    arrays = {
        "ascii": ('format="ascii">' + " ".join(map(str, vel.reshape(-1))) + "</DataArray>", b""),
        "binary": ('format="binary">' + base64.b64encode(blob).decode() + "</DataArray>", b""),
        "appended": ('format="appended" offset="0"/>', b'<AppendedData encoding="raw">_' + blob
                     + b"</AppendedData>"),
    }
    for fmt, (xml, tail) in arrays.items():
        p = tmp_path / f"g_{fmt}.vti"
        p.write_bytes((
            '<?xml version="1.0"?>\n<VTKFile type="ImageData" version="1.0" '
            'byte_order="LittleEndian" header_type="UInt32">\n'
            f'<ImageData WholeExtent="0 {nx-1} 0 {ny-1} 0 {nz-1}" Origin="0 0 0" '
            'Spacing="0.5 0.5 0.5">\n'
            f'<Piece Extent="0 {nx-1} 0 {ny-1} 0 {nz-1}">\n<PointData>\n'
            f'<DataArray type="Float32" Name="velocity" NumberOfComponents="3" {xml}\n'
            '<DataArray type="Float32" Name="mag" format="ascii">'
            + " ".join(map(str, scal)) + "</DataArray>\n"
            "</PointData>\n</Piece>\n</ImageData>\n").encode() + tail + b"</VTKFile>\n")
        _grid_equal(p)
    # .dat/.raw (vector and scalar formats).
    vz = vel.reshape(nz, ny, nx, 3)
    (tmp_path / "f.raw").write_bytes(vz.tobytes())
    (tmp_path / "f.dat").write_text(f"ObjectFileName: f.raw\nResolution: {nx} {ny} {nz}\n"
                                    "Format: FLOAT3\nSliceThickness: 1 2 3\n")
    _grid_equal(tmp_path / "f.dat")
    (tmp_path / "s.raw").write_bytes((scal * 255).astype(np.uint8).tobytes())
    (tmp_path / "s.dat").write_text(f"ObjectFileName: s.raw\nResolution: {nx},{ny},{nz}\n"
                                    "Format: UCHAR\n")
    _grid_equal(tmp_path / "s.dat")
    # AmiraMesh and .field.
    am = tmp_path / "flow.am"
    am.write_bytes((f"# AmiraMesh BINARY-LITTLE-ENDIAN 2.1\n\ndefine Lattice {nx} {ny} {nz}\n\n"
                    "Parameters {\n    BoundingBox 0 2 0 1.5 0 1,\n}\n\n"
                    "Lattice { float[3] Data } @1\n\n").encode() + b"@1\n" + vz.tobytes())
    _grid_equal(am)
    fld = tmp_path / "flow.field"
    fld.write_bytes(np.asarray([nx, ny, nz, 3, 1, 0], "<u4").tobytes() + vz.tobytes())
    _grid_equal(fld)
    # NetCDF with a time axis, coordinates and a named scalar.
    path = str(tmp_path / "wind.nc")
    f = netcdf_file(path, "w")
    for name, size in (("time", 2), ("zdim", nz), ("ydim", ny), ("xdim", nx)):
        f.createDimension(name, size)
    for name in ("u", "v", "w", "t"):
        f.createVariable(name, "f", ("time", "zdim", "ydim", "xdim"))[:] = rng.normal(
            size=(2, nz, ny, nx)).astype(np.float32)
    f.variables["t"].standard_name = "Temperature"
    f.createVariable("zdim", "f", ("zdim",))[:] = np.arange(nz, dtype=np.float32) * 2.0
    f.close()
    _grid_equal(path)
    a, b = jgl.load_netcdf_grid(path, time=1), tgl.load_netcdf_grid(path, time=1)
    assert np.array_equal(a.velocity, b.velocity) and np.array_equal(a.spacing, b.spacing)
    # RBC .bin takes exactly 1024 x 32 x 1024 cells; GRIB is gated.
    bad = tmp_path / "x.bin"
    np.zeros(16, np.float32).tofile(bad)
    for mod in (jgl, tgl):
        with pytest.raises(ValueError, match="expected 1024x32x1024x4"):
            mod.load_grid_file(str(bad))
        with pytest.raises((ImportError, NotImplementedError)):
            mod.load_grid_file(str(tmp_path / "some.grib2"))
        with pytest.raises(ValueError, match="Unknown grid file extension"):
            mod.load_grid_file(str(tmp_path / "x.foo"))
    # A loaded grid through the port's grid streamline tracer.
    from linevis_tpu_torch.trace.streamline import (
        StreamlineTracingSettings,
        trace_streamlines_grid,
    )

    seeds = np.random.default_rng(1).uniform(0.2, 0.8, (8, 3)).astype(np.float32)
    traj = trace_streamlines_grid(g.velocity, StreamlineTracingSettings(
        num_seeds=8, max_steps=16, dt=0.01), seeds, device="cpu")
    assert traj.num_lines == 8 and np.isfinite(traj.positions).all()
    assert int(traj.mask.sum()) > 16
