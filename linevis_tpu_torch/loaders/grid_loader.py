"""Structured vector-field grid loaders for the streamline tracer.

Counterpart of `linevis_tpu/loaders/grid_loader.py`: a host-side numpy copy
whose grids feed the port's `trace/streamline.py:trace_streamlines_grid`.

Mirrors the reference's grid loader family (`src/LineData/Flow/Loader/*`,
~2,900 LoC across 9 loaders).  Implemented here:

- VTK legacy structured grids, ASCII and BINARY (big-endian), DATASET
  STRUCTURED_POINTS / STRUCTURED_GRID with POINT_DATA VECTORS + SCALARS
  (`StructuredGridVtkLoader.cpp:216-380` token grammar).
- `.dat`/`.raw` pairs: text header with resolution + format, raw
  little-endian binary payload (`DatRawFileLoader.cpp` role).

Outputs are channels-last [Z, Y, X, 3] velocity grids (+ named scalar
fields) feeding `trace_streamlines_grid` (trace/streamline.py) — VTK's
value order is x-fastest, so a flat array reshapes to (Z, Y, X) directly.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["GridData", "load_vtk_structured_grid", "load_dat_raw_grid",
           "load_netcdf_grid", "load_grid_file"]


@dataclasses.dataclass
class GridData:
    """A structured vector-field grid + optional scalar fields."""

    velocity: np.ndarray  # [Z, Y, X, 3] float32
    scalars: Dict[str, np.ndarray]  # each [Z, Y, X] float32
    origin: np.ndarray  # [3] world min corner
    spacing: np.ndarray  # [3] cell size

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.velocity.shape[:3]


def _reshape_zyx(values: np.ndarray, nx: int, ny: int, nz: int, comps: int):
    if comps == 1:
        return values.reshape(nz, ny, nx)
    return values.reshape(nz, ny, nx, comps)


def load_vtk_structured_grid(filename: str) -> GridData:
    with open(filename, "rb") as f:
        raw = f.read()

    # Header lines are ASCII even in BINARY files.
    pos = 0

    def next_line():
        nonlocal pos
        end = raw.find(b"\n", pos)
        if end < 0:
            line, new_pos = raw[pos:], len(raw)
        else:
            line, new_pos = raw[pos:end], end + 1
        pos = new_pos
        return line.decode("ascii", "replace").strip()

    binary = False
    nx = ny = nz = 0
    origin = np.zeros(3, np.float32)
    spacing = np.ones(3, np.float32)
    velocity: Optional[np.ndarray] = None
    scalars: Dict[str, np.ndarray] = {}
    n_points = 0

    def read_floats(count):
        """Read `count` floats after the current header line."""
        nonlocal pos
        if binary:
            arr = np.frombuffer(raw, dtype=">f4", count=count, offset=pos)
            pos += 4 * count
            return arr.astype(np.float32)
        vals = []
        while len(vals) < count and pos < len(raw):
            line = next_line()
            if line:
                vals.extend(float(tok) for tok in line.split())
        return np.asarray(vals[:count], np.float32)

    while pos < len(raw):
        line = next_line()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        key = tok[0].upper()
        if key == "BINARY":
            binary = True
        elif key == "ASCII":
            binary = False
        elif key == "DATASET":
            pass  # STRUCTURED_POINTS or STRUCTURED_GRID
        elif key == "DIMENSIONS":
            nx, ny, nz = int(tok[1]), int(tok[2]), int(tok[3])
        elif key == "ORIGIN":
            origin = np.asarray([float(t) for t in tok[1:4]], np.float32)
        elif key == "SPACING" or key == "ASPECT_RATIO":
            spacing = np.asarray([float(t) for t in tok[1:4]], np.float32)
        elif key == "POINTS":
            count = int(tok[1])
            pts = read_floats(count * 3).reshape(count, 3)
            # Structured grid: infer origin/spacing from the regular
            # lattice corners (reference treats the grid as regular too).
            origin = pts.min(axis=0)
            upper = pts.max(axis=0)
            denom = np.maximum(np.asarray([nx, ny, nz], np.float32) - 1, 1)
            spacing = (upper - origin) / denom
        elif key in ("POINT_DATA", "CELL_DATA"):
            n_points = int(tok[1])
        elif key == "VECTORS":
            count = n_points or nx * ny * nz
            vals = read_floats(count * 3)
            velocity = _reshape_zyx(vals, nx, ny, nz, 3)
        elif key == "SCALARS":
            name = tok[1]
            comps = int(tok[3]) if len(tok) > 3 else 1
            lut = next_line()  # LOOKUP_TABLE line
            if not lut.upper().startswith("LOOKUP_TABLE"):
                # No LUT line: rewind by treating it as data (ASCII only).
                pos -= len(lut) + 1
            count = (n_points or nx * ny * nz) * comps
            vals = read_floats(count)
            scalars[name] = _reshape_zyx(vals, nx, ny, nz, comps)
        # other keys ignored

    if velocity is None:
        raise ValueError(f"{filename}: no VECTORS point data found")
    return GridData(
        velocity=velocity.astype(np.float32),
        scalars=scalars,
        origin=origin,
        spacing=spacing,
    )


def load_dat_raw_grid(filename: str) -> GridData:
    """`.dat` text header + `.raw` binary (DatRawFileLoader role).

    Header keys (case-insensitive): ObjectFileName, Resolution (x y z),
    Format (FLOAT / UCHAR / USHORT), optional SliceThickness.
    Vector fields use Format FLOAT3.
    """
    header: Dict[str, str] = {}
    with open(filename, "r") as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                header[k.strip().lower()] = v.strip()
    res = [int(t) for t in re.split(r"[,\s]+", header["resolution"]) if t]
    nx, ny, nz = res[0], res[1], res[2]
    fmt = header.get("format", "float").lower()
    raw_name = header["objectfilename"]
    raw_path = os.path.join(os.path.dirname(filename) or ".", raw_name)
    spacing = np.ones(3, np.float32)
    if "slicethickness" in header:
        st = [float(t) for t in re.split(r"[,\s]+", header["slicethickness"]) if t]
        spacing = np.asarray(st[:3], np.float32)

    dtype, comps = {
        "float": (np.float32, 1),
        "float3": (np.float32, 3),
        "float4": (np.float32, 4),
        "uchar": (np.uint8, 1),
        "ushort": (np.uint16, 1),
    }[fmt]
    data = np.fromfile(raw_path, dtype=dtype)
    if dtype == np.uint8:
        data = data.astype(np.float32) / 255.0
    elif dtype == np.uint16:
        data = data.astype(np.float32) / 65535.0
    else:
        data = data.astype(np.float32)

    if comps >= 3:
        grid = data.reshape(nz, ny, nx, comps)[..., :3]
        return GridData(grid, {}, np.zeros(3, np.float32), spacing)
    scalar = data.reshape(nz, ny, nx)
    return GridData(
        velocity=np.zeros((nz, ny, nx, 3), np.float32),
        scalars={"scalar": scalar},
        origin=np.zeros(3, np.float32),
        spacing=spacing,
    )


def load_amira_mesh_grid(filename: str) -> GridData:
    """AmiraMesh BINARY-LITTLE-ENDIAN 2.1 lattice vector fields
    (AmiraMeshLoader.cpp:60-160 grammar: `define Lattice x y z`,
    `BoundingBox ...`, data after the `@1` marker)."""
    with open(filename, "rb") as f:
        raw = f.read()
    head = raw[:4096].decode("latin-1")
    if "# AmiraMesh BINARY-LITTLE-ENDIAN 2.1" not in head:
        raise ValueError(f"{filename}: missing AmiraMesh header")
    m = re.search(r"define\s+Lattice\s+(\d+)\s+(\d+)\s+(\d+)", head)
    if not m:
        raise ValueError(f"{filename}: no Lattice definition")
    nx, ny, nz = int(m.group(1)), int(m.group(2)), int(m.group(3))
    bb = re.search(
        r"BoundingBox\s+([-\d.eE+ ]+)", head
    )
    origin = np.zeros(3, np.float32)
    spacing = np.ones(3, np.float32)
    if bb:
        vals = [float(t) for t in bb.group(1).split()[:6]]
        if len(vals) == 6:
            lo = np.asarray(vals[0::2], np.float32)
            hi = np.asarray(vals[1::2], np.float32)
            origin = lo
            spacing = (hi - lo) / np.maximum(
                np.asarray([nx, ny, nz], np.float32) - 1, 1
            )
    # Binary data follows the "@1" marker on its own line.
    at = raw.find(b"\n@1\n")
    if at < 0:
        at = raw.find(b"@1\n")
        start = at + 3
    else:
        start = at + 4
    data = np.frombuffer(raw, dtype="<f4", count=nx * ny * nz * 3,
                         offset=start)
    velocity = data.reshape(nz, ny, nx, 3).astype(np.float32)
    return GridData(velocity, {}, origin, spacing)


def load_rbc_bin_grid(filename: str) -> GridData:
    """Rayleigh-Benard convection binary: 1024x32x1024 cells x 4 floats
    (vx, vy, vz, temperature) (RbcBinFileLoader.cpp:46-80)."""
    xs, ys, zs = 1024, 32, 1024
    data = np.fromfile(filename, dtype="<f4")
    if data.size != xs * ys * zs * 4:
        raise ValueError(
            f"{filename}: expected {xs}x{ys}x{zs}x4 floats, got {data.size}"
        )
    # File layout is x-fastest with 4 components per cell.
    field = data.reshape(zs, ys, xs, 4)
    spacing = np.full(3, 1.0 / 1023.0, np.float32)
    return GridData(
        velocity=field[..., :3].astype(np.float32),
        scalars={"temperature": field[..., 3].astype(np.float32)},
        origin=np.zeros(3, np.float32),
        spacing=spacing,
    )


def load_field_file_grid(filename: str) -> GridData:
    """`.field` binary: uvec3 resolution + dims/mips/type header, then
    vec3 or vec4 float cells (FieldFileLoader.cpp:39-140)."""
    raw = np.fromfile(filename, dtype=np.uint8)
    hdr = np.frombuffer(raw[:24].tobytes(), dtype="<u4")
    nx, ny, nz = int(hdr[0]), int(hdr[1]), int(hdr[2])
    n = nx * ny * nz
    body = raw[24:]
    floats = np.frombuffer(body.tobytes(), dtype="<f4")
    if floats.size >= n * 4 and floats.size % (n * 4) == 0:
        comps = 4
    elif floats.size >= n * 3:
        comps = 3
    else:
        raise ValueError(f"{filename}: payload too small for {nx}x{ny}x{nz}")
    grid = floats[: n * comps].reshape(nz, ny, nx, comps)
    return GridData(
        velocity=grid[..., :3].astype(np.float32),
        scalars={},
        origin=np.zeros(3, np.float32),
        spacing=np.ones(3, np.float32),
    )


def load_vtk_xml_grid(filename: str) -> GridData:
    """VTK XML ImageData (.vti) / StructuredGrid (.vts) vector fields
    (VtkXmlLoader.cpp role): DataArray formats ascii, inline base64
    (UInt32/UInt64 headers, uncompressed), and appended raw/base64."""
    import base64
    import xml.etree.ElementTree as ET

    with open(filename, "rb") as f:
        raw = f.read()
    # Appended data can contain raw bytes that break XML parsing; split it
    # off before parsing if present.
    appended = None
    m = raw.find(b"<AppendedData")
    if m >= 0:
        start = raw.find(b"_", m) + 1
        end = raw.rfind(b"</AppendedData>")
        appended = raw[start:end].strip()
        raw = raw[:m] + b"</VTKFile>"
    root = ET.fromstring(raw.decode("latin-1"))

    header_dtype = {
        "UInt32": np.dtype("<u4"), "UInt64": np.dtype("<u8"),
    }[root.get("header_type", "UInt32")]

    grid_el = None
    for tag in ("ImageData", "StructuredGrid"):
        grid_el = root.find(tag)
        if grid_el is not None:
            break
    if grid_el is None:
        raise ValueError(f"{filename}: no ImageData/StructuredGrid element")

    ext = [int(t) for t in grid_el.get("WholeExtent").split()]
    nx = ext[1] - ext[0] + 1
    ny = ext[3] - ext[2] + 1
    nz = ext[5] - ext[4] + 1
    origin = np.asarray(
        [float(t) for t in (grid_el.get("Origin") or "0 0 0").split()],
        np.float32,
    )
    spacing = np.asarray(
        [float(t) for t in (grid_el.get("Spacing") or "1 1 1").split()],
        np.float32,
    )

    def decode(da) -> np.ndarray:
        dtype = {"Float32": "<f4", "Float64": "<f8"}[da.get("type")]
        fmt = da.get("format", "ascii")
        if fmt == "ascii":
            return np.asarray(
                [float(t) for t in da.text.split()], np.dtype(dtype)
            )
        if fmt == "binary":
            blob = base64.b64decode("".join(da.text.split()))
            n = int(np.frombuffer(blob[: header_dtype.itemsize],
                                  header_dtype)[0])
            return np.frombuffer(
                blob[header_dtype.itemsize : header_dtype.itemsize + n],
                np.dtype(dtype),
            )
        if fmt == "appended":
            off = int(da.get("offset", "0"))
            blob = appended
            if blob[:1] not in (b"\x00",) and blob[:4] not in (b"AQAA",):
                # raw appended: length header + payload at offset
                n = int(np.frombuffer(
                    blob[off : off + header_dtype.itemsize], header_dtype
                )[0])
                start = off + header_dtype.itemsize
                return np.frombuffer(blob[start : start + n], np.dtype(dtype))
            decoded = base64.b64decode(blob)
            n = int(np.frombuffer(
                decoded[off : off + header_dtype.itemsize], header_dtype
            )[0])
            start = off + header_dtype.itemsize
            return np.frombuffer(decoded[start : start + n], np.dtype(dtype))
        raise ValueError(f"unsupported DataArray format {fmt!r}")

    velocity = None
    scalars: Dict[str, np.ndarray] = {}
    pd = grid_el.find("Piece/PointData")
    if pd is None:
        raise ValueError(f"{filename}: no PointData")
    for da in pd.findall("DataArray"):
        comps = int(da.get("NumberOfComponents", "1"))
        vals = decode(da).astype(np.float32)
        name = da.get("Name", "field")
        if comps == 3 and velocity is None:
            velocity = vals.reshape(nz, ny, nx, 3)
        elif comps == 1:
            scalars[name] = vals.reshape(nz, ny, nx)
    if velocity is None:
        velocity = np.zeros((nz, ny, nx, 3), np.float32)
    return GridData(velocity, scalars, origin, spacing)


def _netcdf_open_variables(filename: str):
    """-> (vars {name: ndarray}, dims {name: dim-name tuple},
    attrs {name: {attr: str}}).  NetCDF classic via scipy, NetCDF-4
    (HDF5 container) via h5py — same split as loaders/netcdf_lines.py."""
    try:
        from scipy.io import netcdf_file

        f = netcdf_file(filename, "r", mmap=False)
        try:
            out, dims, attrs = {}, {}, {}
            for name, var in f.variables.items():
                out[name] = np.asarray(var[:])
                dims[name] = tuple(var.dimensions)
                a = {}
                for key in ("standard_name",):
                    val = getattr(var, key, None)
                    if isinstance(val, bytes):
                        val = val.decode()
                    if val:
                        a[key] = val
                attrs[name] = a
            return out, dims, attrs
        finally:
            f.close()
    except Exception:
        pass

    import h5py

    out, dims, attrs = {}, {}, {}
    with h5py.File(filename, "r") as f:
        for name in f.keys():
            ds = f[name]
            if not hasattr(ds, "shape"):
                continue
            out[name] = np.asarray(ds)
            dn = []
            try:
                for dim in ds.dims:
                    labels = list(dim.keys())
                    dn.append(labels[0] if labels else "")
            except Exception:
                dn = [""] * out[name].ndim
            dims[name] = tuple(dn)
            a = {}
            val = ds.attrs.get("standard_name")
            if isinstance(val, bytes):
                val = val.decode()
            if val:
                a["standard_name"] = val
            attrs[name] = a
    return out, dims, attrs


def load_netcdf_grid(
    filename: str,
    time: int = 0,
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> GridData:
    """NetCDF vector-field grids for the streamline tracer (reference
    `src/LineData/Flow/Loader/NetCdfLoader.cpp:113-360`):

    - wind components from variables u/v/w or U/V/W;
    - 3-D (z, y, x) fields, or 4-D (time, z, y, x) with the `time` slice
      selected (GridDataSetMetaData.time);
    - grid coordinates from 1-D variables named like the dimensions
      (z falls back to `vcoord`, COSMO style), else unit index spacing;
    - lat/lon grids keep unit spacing (isLatLonData), regular grids scale
      per-axis spacing by coordinate deltas, everything normalized so the
      largest axis spans [0, 1] (cellStep = 1 / maxDimension);
    - every further float variable with the same dimensionality becomes a
      named scalar field (display name from `standard_name`).
    """
    variables, dims, attrs = _netcdf_open_variables(filename)

    comp_names = None
    for cand in (("u", "v", "w"), ("U", "V", "W")):
        if all(c in variables for c in cand):
            comp_names = cand
            break
    if comp_names is None:
        raise ValueError(
            f"{filename}: no u/v/w (or U/V/W) wind components found"
        )
    u = variables[comp_names[0]]
    v = variables[comp_names[1]]
    w = variables[comp_names[2]]
    ndims = u.ndim
    if ndims == 4:
        u, v, w = u[time], v[time], w[time]
        dim_zyx = dims[comp_names[0]][1:]
    elif ndims == 3:
        dim_zyx = dims[comp_names[0]]
    else:
        raise ValueError(
            f"{filename}: wind components must be 3-D or 4-D, got {ndims}-D"
        )
    nz, ny, nx = u.shape

    def coords_for(dim_name, length, fallback=None):
        if dim_name and dim_name in variables and \
                variables[dim_name].ndim == 1:
            return np.asarray(variables[dim_name], np.float64)
        if fallback and fallback in variables and \
                variables[fallback].ndim == 1:
            return np.asarray(variables[fallback], np.float64)
        return np.arange(length, dtype=np.float64)

    z_c = coords_for(dim_zyx[0], nz, fallback="vcoord")
    y_c = coords_for(dim_zyx[1], ny)
    x_c = coords_for(dim_zyx[2], nx)
    is_lat_lon = any(
        ("lat" in (d or "")) or ("lon" in (d or "")) for d in dim_zyx[1:]
    )

    d_coords = np.ones(3)
    if not is_lat_lon:
        for i, (c, n) in enumerate(((x_c, nx), (y_c, ny), (z_c, nz))):
            if n > 1 and c.shape[0] >= n:
                d_coords[i] = (c[n - 1] - c[0]) / float(n - 1)
    max_delta = max(d_coords.max(), 1e-12)
    max_dim = float(max(nx - 1, ny - 1, nz - 1, 1))
    cell_step = 1.0 / max_dim
    spacing = np.asarray(
        [cell_step * scale[i] * d_coords[i] / max_delta for i in range(3)],
        np.float32,
    )

    velocity = np.stack(
        [u.astype(np.float32), v.astype(np.float32), w.astype(np.float32)],
        axis=-1,
    )
    scalars: Dict[str, np.ndarray] = {
        comp_names[0]: velocity[..., 0],
        comp_names[1]: velocity[..., 1],
        comp_names[2]: velocity[..., 2],
    }
    for name, data in variables.items():
        if name in comp_names or data.dtype.kind != "f":
            continue
        if data.ndim != ndims:
            continue
        field = data[time] if ndims == 4 else data
        if field.shape != (nz, ny, nx):
            continue
        display = attrs.get(name, {}).get("standard_name", name)
        scalars[display] = field.astype(np.float32)

    return GridData(
        velocity=velocity,
        scalars=scalars,
        origin=np.zeros(3, np.float32),
        spacing=spacing,
    )


def load_grib_grid(filename: str) -> GridData:
    """GRIB vector fields (reference `Flow/Loader/GribLoader.cpp`, an
    OPTIONAL dependency there too — gated on eccodes at build time).
    This environment ships no eccodes/cfgrib; the loader is gated with a
    clear error rather than silently mis-parsing."""
    try:
        import eccodes  # noqa: F401
    except ImportError:
        try:
            import cfgrib  # noqa: F401
        except ImportError:
            raise ImportError(
                "GRIB support needs the 'eccodes' (or 'cfgrib') package, "
                "which is not installed; convert the file to NetCDF "
                "(.nc) or VTK and load that instead (the reference "
                "gates its GribLoader on ecCodes the same way)."
            ) from None
    raise NotImplementedError(
        "eccodes found but GRIB decoding is not wired up in this build"
    )


def load_grid_file(filename: str) -> GridData:
    lower = filename.lower()
    if lower.endswith((".grib", ".grb", ".grib2")):
        return load_grib_grid(filename)
    if lower.endswith(".vtk"):
        return load_vtk_structured_grid(filename)
    if lower.endswith((".vti", ".vts")):
        return load_vtk_xml_grid(filename)
    if lower.endswith(".dat"):
        return load_dat_raw_grid(filename)
    if lower.endswith(".am"):
        return load_amira_mesh_grid(filename)
    if lower.endswith(".field"):
        return load_field_file_grid(filename)
    if lower.endswith(".bin"):
        return load_rbc_bin_grid(filename)
    if lower.endswith((".nc", ".nc4", ".cdf")):
        return load_netcdf_grid(filename)
    raise ValueError(f"Unknown grid file extension: {filename}")
