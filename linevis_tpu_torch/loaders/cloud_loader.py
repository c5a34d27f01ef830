"""Cloud density-grid loaders for the volumetric path tracer.

Counterpart of `linevis_tpu/loaders/cloud_loader.py`: a host-side numpy copy,
equal to it bit for bit (the `(0, lowest)` min-max seed included).

Mirrors the reference's `CloudData` file formats
(`src/LineData/Scattering/CloudData.{hpp:43-108,cpp:86-412}`):

- `.xyz`: 3x uint32 grid size, 3x double voxel size, dense float field
  stored x-major (z fastest) and transposed to [Z, Y, X]; min-max
  normalized with the reference's (0, lowest) reduction seed.
- `.dat`/`.raw` pairs: case-insensitive `key: value` header
  (ObjectFileName / Resolution / Format uchar|ushort|float), values
  scaled to [0,1] per format then min-max normalized like `.xyz`.
- `.nvdb`: NanoVDB sparse grids.  No NanoVDB library exists in this
  environment, so this is a from-scratch reader of the published file
  and in-memory layout — offsets follow the reference's own GLSL mirror
  (`Data/Shaders/Scattering/Clouds/PNanoVDB.glsl:631-1460`) and
  `nanovdb/util/IO.h:104-160` (Header 16 B, MetaData 176 B).  FLOAT
  grids with codec NONE are supported; the tree (root tiles -> 32^3
  upper -> 16^3 lower -> 8^3 leaf) is decoded into a dense [Z, Y, X]
  field over the index bounding box, exactly like the reference's
  `CloudData::getDenseDensityField` (CloudData.cpp:413-444, no
  normalization).  `write_nvdb` emits the same single-grid layout for
  round-trip tests and interop.

World-space bounds follow `computeGridBounds` (CloudData.cpp:57-61):
box_max = gridSize * 0.25 / maxDim, box_min = -box_max.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "CloudData",
    "load_cloud_file",
    "load_cloud_xyz",
    "load_cloud_dat_raw",
    "load_cloud_nvdb",
    "write_cloud_xyz",
    "write_nvdb",
]

_NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0", PNanoVDB.glsl:631
_GRID_TYPE_FLOAT = 1
_GRID_SIZE = 672  # pnanovdb_grid_t, PNanoVDB.glsl:739-758
_TREE_SIZE = 64
# FLOAT-row grid-type constants (PNanoVDB.glsl:1157-1162, row 1).
_ROOT_OFF_BACKGROUND = 28
_ROOT_SIZE = 64
_ROOT_TILE_OFF_VALUE = 20
_ROOT_TILE_SIZE = 32
_UPPER_OFF_TABLE = 8256
_UPPER_SIZE = 270400
_LOWER_OFF_TABLE = 1088
_LOWER_SIZE = 33856
_LEAF_OFF_TABLE = 96
_LEAF_SIZE = 2144
_TABLE_STRIDE = 8


@dataclasses.dataclass
class CloudData:
    """Dense cloud density grid (the reference CloudData's dense side)."""

    density: np.ndarray  # [Z, Y, X] float32
    voxel_size: np.ndarray  # [3] float32
    box_min: np.ndarray  # [3] world-space bounds
    box_max: np.ndarray

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.density.shape


def _grid_bounds(nx: int, ny: int, nz: int):
    """computeGridBounds (CloudData.cpp:57-61)."""
    max_dim = float(max(nx, ny, nz))
    box_max = np.asarray([nx, ny, nz], np.float32) * 0.25 / max_dim
    return -box_max, box_max


def _minmax_normalize(density: np.ndarray) -> np.ndarray:
    # The reference seeds the reduction with (0.0, float lowest)
    # (CloudData.cpp:172-174), so the minimum saturates at <= 0.
    min_v = min(float(density.min()), 0.0)
    max_v = float(density.max())
    return ((density - min_v) / (max_v - min_v)).astype(np.float32)


def load_cloud_xyz(filename: str) -> CloudData:
    with open(filename, "rb") as f:
        raw = f.read()
    nx, ny, nz = struct.unpack_from("<III", raw, 0)
    vx, vy, vz = struct.unpack_from("<ddd", raw, 12)
    data = np.frombuffer(raw, "<f4", count=nx * ny * nz, offset=36)
    # File layout is x-major, z fastest: index = z + gz*(y + gy*x)
    # (CloudData.cpp:156-163 transpose); [X, Y, Z] -> [Z, Y, X].
    density = data.reshape(nx, ny, nz).transpose(2, 1, 0)
    density = _minmax_normalize(density)
    box_min, box_max = _grid_bounds(nx, ny, nz)
    return CloudData(
        density=density,
        voxel_size=np.asarray([vx, vy, vz], np.float32),
        box_min=box_min,
        box_max=box_max,
    )


def write_cloud_xyz(filename: str, density_zyx: np.ndarray,
                    voxel_size=(1.0, 1.0, 1.0)) -> None:
    nz, ny, nx = density_zyx.shape
    with open(filename, "wb") as f:
        f.write(struct.pack("<III", nx, ny, nz))
        f.write(struct.pack("<ddd", *voxel_size))
        f.write(
            np.ascontiguousarray(
                density_zyx.transpose(2, 1, 0), "<f4"
            ).tobytes()
        )


def load_cloud_dat_raw(filename: str) -> CloudData:
    """`.dat`/`.raw` volume pairs (CloudData::loadFromDatRawFile)."""
    if filename.endswith(".raw"):
        directory = os.path.dirname(filename) or "."
        dats = [f for f in os.listdir(directory) if f.endswith(".dat")]
        if not dats:
            raise FileNotFoundError(
                f"No .dat metadata next to raw file {filename!r}"
            )
        dat_path = os.path.join(directory, dats[0])
    else:
        dat_path = filename
    entries: Dict[str, str] = {}
    with open(dat_path, "r") as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            entries[key.strip().lower()] = value.strip()
    if "resolution" not in entries:
        raise ValueError(f"Entry 'Resolution' missing in {dat_path!r}")
    nx, ny, nz = (int(tok) for tok in entries["resolution"].split())
    fmt = entries.get("format", "").lower()
    if fmt not in ("float", "uchar", "ushort"):
        raise ValueError(f"Unsupported format {fmt!r} in {dat_path!r}")
    raw_name = entries.get("objectfilename")
    if raw_name is None:
        raise ValueError(f"Entry 'ObjectFileName' missing in {dat_path!r}")
    raw_path = os.path.join(os.path.dirname(dat_path) or ".", raw_name)
    dtype = {"float": "<f4", "uchar": "u1", "ushort": "<u2"}[fmt]
    data = np.fromfile(raw_path, dtype=dtype)
    if data.size != nx * ny * nz:
        raise ValueError(
            f"Invalid number of entries in {raw_path!r}: got {data.size}, "
            f"expected {nx * ny * nz}"
        )
    density = data.reshape(nz, ny, nx).astype(np.float32)
    if fmt == "uchar":
        density /= 255.0
    elif fmt == "ushort":
        density /= 65535.0
    density = _minmax_normalize(density)
    box_min, box_max = _grid_bounds(nx, ny, nz)
    cell_step = 1.0 / float(max(nx - 1, ny - 1, nz - 1, 1))
    return CloudData(
        density=density,
        voxel_size=np.full((3,), cell_step, np.float32),
        box_min=box_min,
        box_max=box_max,
    )


# ---------------------------------------------------------------------------
# NanoVDB (.nvdb)
# ---------------------------------------------------------------------------


def _u32(buf, off):
    return struct.unpack_from("<I", buf, off)[0]


def _u64(buf, off):
    return struct.unpack_from("<Q", buf, off)[0]


def _i64(buf, off):
    return struct.unpack_from("<q", buf, off)[0]


def load_cloud_nvdb(filename: str) -> CloudData:
    with open(filename, "rb") as f:
        raw = f.read()
    # File segment header (IO.h:112-125): magic u64, version u32,
    # gridCount u16, codec u16.
    if _u64(raw, 0) != _NANOVDB_MAGIC:
        raise ValueError(f"{filename}: not a NanoVDB file (bad magic)")
    grid_count = struct.unpack_from("<H", raw, 12)[0]
    codec = struct.unpack_from("<H", raw, 14)[0]
    if codec != 0:
        raise ValueError(
            f"{filename}: compressed NanoVDB (codec {codec}) not supported; "
            "re-save with codec NONE"
        )
    if grid_count < 1:
        raise ValueError(f"{filename}: empty NanoVDB segment")
    # MetaData (IO.h:144-160, 176 bytes) + gridName, per grid; the grid
    # buffers follow the last metadata record.
    off = 16
    metas = []
    for _ in range(grid_count):
        grid_size = _u64(raw, off + 0)
        file_size = _u64(raw, off + 8)
        grid_type = _u32(raw, off + 32)
        index_bbox = struct.unpack_from("<6i", raw, off + 88)
        voxel_size = struct.unpack_from("<3d", raw, off + 112)
        name_size = _u32(raw, off + 136)
        metas.append(
            (grid_size, file_size, grid_type, index_bbox, voxel_size)
        )
        off += 176 + name_size
    data_off = off
    for grid_size, file_size, grid_type, index_bbox, voxel_size in metas:
        if grid_type == _GRID_TYPE_FLOAT:
            return _decode_nvdb_float_grid(
                raw[data_off : data_off + grid_size], index_bbox, voxel_size
            )
        data_off += file_size
    raise ValueError(f"{filename}: no FLOAT grid in NanoVDB file")


def _decode_nvdb_float_grid(buf, index_bbox, voxel_size) -> CloudData:
    """Dense-extract one FLOAT grid buffer (PNanoVDB.glsl layout)."""
    if _u32(buf, 636) != _GRID_TYPE_FLOAT:  # PNANOVDB_GRID_OFF_GRID_TYPE
        raise ValueError("grid buffer is not a FLOAT grid")
    tree = _GRID_SIZE
    root = tree + _u64(buf, tree + 24)  # TREE_OFF_NODE_OFFSET_ROOT
    tile_count = _u32(buf, root + 24)  # ROOT_OFF_TABLE_SIZE
    background = struct.unpack_from("<f", buf, root + _ROOT_OFF_BACKGROUND)[0]

    i0, j0, k0, i1, j1, k1 = index_bbox
    nx, ny, nz = i1 - i0 + 1, j1 - j0 + 1, k1 - k0 + 1
    density = np.full((nz, ny, nx), background, np.float32)

    # Walk root tiles -> upper -> lower -> leaf, writing node extents.
    for t in range(tile_count):
        tile = root + _ROOT_SIZE + t * _ROOT_TILE_SIZE
        key = _u64(buf, tile)
        child = _i64(buf, tile + 8)
        # Key packs ijk >> 12 as (k | j<<21 | i<<42) (PNanoVDB.glsl:1237).
        ku = key & 0x1FFFFF
        ju = (key >> 21) & 0x1FFFFF
        iu = (key >> 42) & 0x1FFFFF

        def sext(v):  # the key stores (int32 >> 12) as unsigned
            return v - (1 << 21) if v >= (1 << 20) else v

        oi, oj, ok = sext(iu) << 12, sext(ju) << 12, sext(ku) << 12
        if child == 0:
            # Value tile: state u32 at 16, value at 20.
            state = _u32(buf, tile + 16)
            if state != 0:
                val = struct.unpack_from(
                    "<f", buf, tile + _ROOT_TILE_OFF_VALUE
                )[0]
                _fill(density, i0, j0, k0, oi, oj, ok, 4096, val)
            continue
        _decode_upper(
            buf, root + child, oi, oj, ok, density, i0, j0, k0
        )

    box_min, box_max = _grid_bounds(nx, ny, nz)
    return CloudData(
        density=density,
        voxel_size=np.asarray(voxel_size, np.float32),
        box_min=box_min,
        box_max=box_max,
    )


def _fill(density, i0, j0, k0, oi, oj, ok, extent, val):
    nz, ny, nx = density.shape
    x0, y0, z0 = oi - i0, oj - j0, ok - k0
    xs = slice(max(x0, 0), min(x0 + extent, nx))
    ys = slice(max(y0, 0), min(y0 + extent, ny))
    zs = slice(max(z0, 0), min(z0 + extent, nz))
    if xs.start < xs.stop and ys.start < ys.stop and zs.start < zs.stop:
        density[zs, ys, xs] = val


def _mask_bits(buf, off, nbits):
    # Bit n of a NanoVDB mask lives at byte n>>3, bit n&7 (little-endian
    # word reads in PNanoVDB.glsl:1041-1046).
    raw = np.frombuffer(buf, np.uint8, count=nbits // 8, offset=off)
    return np.unpackbits(raw, bitorder="little").astype(bool)


def _decode_upper(buf, addr, oi, oj, ok, density, i0, j0, k0):
    value_mask = _mask_bits(buf, addr + 32, 32768)
    child_mask = _mask_bits(buf, addr + 4128, 32768)
    table = addr + _UPPER_OFF_TABLE
    for n in np.nonzero(value_mask | child_mask)[0]:
        # n = (((x&4095)>>7)<<10) | (((y&4095)>>7)<<5) | ((z&4095)>>7)
        ci = oi + ((n >> 10) & 31) * 128
        cj = oj + ((n >> 5) & 31) * 128
        ck = ok + (n & 31) * 128
        entry = table + int(n) * _TABLE_STRIDE
        if child_mask[n]:
            child = _i64(buf, entry)
            _decode_lower(buf, addr + child, ci, cj, ck, density, i0, j0, k0)
        else:
            val = struct.unpack_from("<f", buf, entry)[0]
            _fill(density, i0, j0, k0, ci, cj, ck, 128, val)


def _decode_lower(buf, addr, oi, oj, ok, density, i0, j0, k0):
    value_mask = _mask_bits(buf, addr + 32, 4096)
    child_mask = _mask_bits(buf, addr + 544, 4096)
    table = addr + _LOWER_OFF_TABLE
    for n in np.nonzero(value_mask | child_mask)[0]:
        ci = oi + ((n >> 8) & 15) * 8
        cj = oj + ((n >> 4) & 15) * 8
        ck = ok + (n & 15) * 8
        entry = table + int(n) * _TABLE_STRIDE
        if child_mask[n]:
            child = _i64(buf, entry)
            _decode_leaf(buf, addr + child, ci, cj, ck, density, i0, j0, k0)
        else:
            val = struct.unpack_from("<f", buf, entry)[0]
            _fill(density, i0, j0, k0, ci, cj, ck, 8, val)


def _decode_leaf(buf, addr, oi, oj, ok, density, i0, j0, k0):
    value_mask = _mask_bits(buf, addr + 16, 512)
    values = np.frombuffer(buf, "<f4", count=512, offset=addr + _LEAF_OFF_TABLE)
    # n = ((x&7)<<6) | ((y&7)<<3) | (z&7) -> reshape [X, Y, Z].
    vol = values.reshape(8, 8, 8).transpose(2, 1, 0)  # -> [Z, Y, X]
    msk = value_mask.reshape(8, 8, 8).transpose(2, 1, 0)
    nz, ny, nx = density.shape
    x0, y0, z0 = oi - i0, oj - j0, ok - k0
    xs = slice(max(x0, 0), min(x0 + 8, nx))
    ys = slice(max(y0, 0), min(y0 + 8, ny))
    zs = slice(max(z0, 0), min(z0 + 8, nz))
    if xs.start >= xs.stop or ys.start >= ys.stop or zs.start >= zs.stop:
        return
    lx = slice(xs.start - x0, xs.stop - x0)
    ly = slice(ys.start - y0, ys.stop - y0)
    lz = slice(zs.start - z0, zs.stop - z0)
    sub_m = msk[lz, ly, lx]
    target = density[zs, ys, xs]
    target[sub_m] = vol[lz, ly, lx][sub_m]
    density[zs, ys, xs] = target


def write_nvdb(filename: str, density_zyx: np.ndarray,
               voxel_size=(1.0, 1.0, 1.0),
               background: float = 0.0,
               grid_name: str = "density") -> None:
    """Write a dense [Z, Y, X] field as a single-FLOAT-grid NanoVDB file
    (codec NONE) in the PNanoVDB.glsl layout — for round-trip tests and
    tools interop.  Leaves fully equal to `background` are omitted
    (value tiles), giving real sparsity."""
    density_zyx = np.asarray(density_zyx, np.float32)
    nz, ny, nx = density_zyx.shape
    if nx > 4096 or ny > 4096 or nz > 4096:
        raise ValueError("write_nvdb supports one upper node per axis span "
                         "(<= 4096 voxels); shard larger grids")

    # Gather leaves (8^3), lowers (16^3 of leaves = 128^3 voxels), one
    # upper per 4096^3 region -> single root tile at origin.
    leaf_blobs = []
    lower_entries: Dict[Tuple[int, int, int], Dict] = {}
    n_lx = -(-nx // 8)
    n_ly = -(-ny // 8)
    n_lz = -(-nz // 8)
    for bx in range(n_lx):
        for by in range(n_ly):
            for bz in range(n_lz):
                x0, y0, z0 = bx * 8, by * 8, bz * 8
                block = np.full((8, 8, 8), background, np.float32)  # [Z,Y,X]
                sub = density_zyx[z0 : z0 + 8, y0 : y0 + 8, x0 : x0 + 8]
                block[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = sub
                if np.all(block == background):
                    continue
                mask = np.zeros((8, 8, 8), bool)
                mask[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = True
                lower_key = (x0 // 128, y0 // 128, z0 // 128)
                entry = lower_entries.setdefault(lower_key, {})
                ln = (((x0 // 8) & 15) << 8) | (((y0 // 8) & 15) << 4) | (
                    (z0 // 8) & 15
                )
                entry[ln] = len(leaf_blobs)
                leaf_blobs.append(
                    _encode_leaf(x0, y0, z0, block, mask)
                )

    lower_blobs = []
    upper_children: Dict[int, int] = {}
    for (ux, uy, uz), entry in sorted(lower_entries.items()):
        un = ((ux & 31) << 10) | ((uy & 31) << 5) | (uz & 31)
        upper_children[un] = len(lower_blobs)
        lower_blobs.append((entry, (ux * 128, uy * 128, uz * 128)))

    # Layout: grid | tree | root | tiles | upper | lowers | leaves.
    n_lower = len(lower_blobs)
    n_leaf = len(leaf_blobs)
    root_off = _GRID_SIZE + _TREE_SIZE
    tile_off = root_off + _ROOT_SIZE
    upper_off = tile_off + _ROOT_TILE_SIZE
    lower_off = upper_off + _UPPER_SIZE
    leaf_off = lower_off + n_lower * _LOWER_SIZE
    total = leaf_off + n_leaf * _LEAF_SIZE

    grid = bytearray(total)
    struct.pack_into("<Q", grid, 0, _NANOVDB_MAGIC)
    struct.pack_into("<I", grid, 16, (32 << 21) | (3 << 10))  # version 32.3
    struct.pack_into("<I", grid, 28, 1)  # grid_count
    struct.pack_into("<Q", grid, 32, total)  # grid_size
    name_b = grid_name.encode()[:255]
    grid[40 : 40 + len(name_b)] = name_b
    # Map: identity matf/invmatf/matd/invmatd scaled by voxel size.
    for c in range(3):
        struct.pack_into("<f", grid, 296 + 4 * (4 * c), voxel_size[c])
        struct.pack_into("<f", grid, 296 + 36 + 4 * (4 * c),
                         1.0 / voxel_size[c])
        struct.pack_into("<d", grid, 296 + 88 + 8 * (4 * c), voxel_size[c])
        struct.pack_into("<d", grid, 296 + 160 + 8 * (4 * c),
                         1.0 / voxel_size[c])
    for c, ext in enumerate((nx, ny, nz)):
        struct.pack_into("<d", grid, 560 + 8 * c, 0.0)
        struct.pack_into("<d", grid, 560 + 24 + 8 * c,
                         ext * voxel_size[c])
        struct.pack_into("<d", grid, 608 + 8 * c, voxel_size[c])
    struct.pack_into("<I", grid, 632, 1)  # grid_class FOG_VOLUME
    struct.pack_into("<I", grid, 636, _GRID_TYPE_FLOAT)

    # Tree: node offsets relative to the tree address (_GRID_SIZE).
    tree = _GRID_SIZE
    struct.pack_into("<Q", grid, tree + 0, leaf_off - tree)
    struct.pack_into("<Q", grid, tree + 8, lower_off - tree)
    struct.pack_into("<Q", grid, tree + 16, upper_off - tree)
    struct.pack_into("<Q", grid, tree + 24, root_off - tree)
    struct.pack_into("<I", grid, tree + 32, n_leaf)
    struct.pack_into("<I", grid, tree + 36, n_lower)
    struct.pack_into("<I", grid, tree + 40, 1)
    struct.pack_into("<Q", grid, tree + 56,
                     int(np.count_nonzero(density_zyx != background)))

    # Root: index bbox [0, n-1], one tile.
    struct.pack_into("<3i", grid, root_off + 0, 0, 0, 0)
    struct.pack_into("<3i", grid, root_off + 12, nx - 1, ny - 1, nz - 1)
    struct.pack_into("<I", grid, root_off + 24, 1)  # table_size
    struct.pack_into("<f", grid, root_off + _ROOT_OFF_BACKGROUND, background)
    # Tile: key of origin (0), child offset relative to ROOT address.
    struct.pack_into("<Q", grid, tile_off + 0, 0)
    struct.pack_into("<q", grid, tile_off + 8, upper_off - root_off)
    struct.pack_into("<I", grid, tile_off + 16, 1)  # state active

    # Upper node.
    struct.pack_into("<3i", grid, upper_off + 0, 0, 0, 0)
    struct.pack_into("<3i", grid, upper_off + 12, nx - 1, ny - 1, nz - 1)
    child_mask = np.zeros(32768 // 8, np.uint8)
    for un, li in upper_children.items():
        child_mask[un >> 3] |= 1 << (un & 7)
        entry = upper_off + _UPPER_OFF_TABLE + un * _TABLE_STRIDE
        struct.pack_into(
            "<q", grid, entry,
            (lower_off + li * _LOWER_SIZE) - upper_off,
        )
    grid[upper_off + 4128 : upper_off + 4128 + 4096] = child_mask.tobytes()

    # Lower nodes.
    for li, (entry_map, _origin) in enumerate(lower_blobs):
        addr = lower_off + li * _LOWER_SIZE
        cmask = np.zeros(4096 // 8, np.uint8)
        for ln, leaf_i in entry_map.items():
            cmask[ln >> 3] |= 1 << (ln & 7)
            entry = addr + _LOWER_OFF_TABLE + ln * _TABLE_STRIDE
            struct.pack_into(
                "<q", grid, entry,
                (leaf_off + leaf_i * _LEAF_SIZE) - addr,
            )
        grid[addr + 544 : addr + 544 + 512] = cmask.tobytes()

    # Leaves.
    for leaf_i, blob in enumerate(leaf_blobs):
        addr = leaf_off + leaf_i * _LEAF_SIZE
        grid[addr : addr + _LEAF_SIZE] = blob

    # File: Header (16 B) + MetaData (176 B) + name + grid buffer.
    header = struct.pack(
        "<QIHH", _NANOVDB_MAGIC, (32 << 21) | (3 << 10), 1, 0
    )
    meta = bytearray(176)
    struct.pack_into("<Q", meta, 0, total)  # gridSize
    struct.pack_into("<Q", meta, 8, total)  # fileSize (uncompressed)
    struct.pack_into("<Q", meta, 24,
                     int(np.count_nonzero(density_zyx != background)))
    struct.pack_into("<I", meta, 32, _GRID_TYPE_FLOAT)
    struct.pack_into("<I", meta, 36, 1)  # gridClass FOG_VOLUME
    for c, ext in enumerate((nx, ny, nz)):
        struct.pack_into("<d", meta, 40 + 8 * c, 0.0)
        struct.pack_into("<d", meta, 64 + 8 * c, ext * voxel_size[c])
    struct.pack_into("<6i", meta, 88, 0, 0, 0, nx - 1, ny - 1, nz - 1)
    struct.pack_into("<3d", meta, 112, *voxel_size)
    struct.pack_into("<I", meta, 136, len(name_b) + 1)
    struct.pack_into("<4I", meta, 140, n_leaf, n_lower, 1, 1)
    struct.pack_into("<I", meta, 172, (32 << 21) | (3 << 10))
    with open(filename, "wb") as f:
        f.write(header)
        f.write(meta)
        f.write(name_b + b"\x00")
        f.write(grid)


def _encode_leaf(x0, y0, z0, block_zyx, mask_zyx) -> bytes:
    blob = bytearray(_LEAF_SIZE)
    struct.pack_into("<3i", blob, 0, x0, y0, z0)
    mask_xyz = mask_zyx.transpose(2, 1, 0)  # n = x<<6 | y<<3 | z
    bits = np.packbits(mask_xyz.reshape(-1), bitorder="little")
    blob[16 : 16 + 64] = bits.tobytes()
    vals = np.ascontiguousarray(
        block_zyx.transpose(2, 1, 0), "<f4"
    )
    struct.pack_into("<f", blob, 80, float(block_zyx.min()))
    struct.pack_into("<f", blob, 84, float(block_zyx.max()))
    blob[_LEAF_OFF_TABLE : _LEAF_OFF_TABLE + 2048] = vals.tobytes()
    return bytes(blob)


def load_cloud_file(filename: str) -> CloudData:
    """Extension dispatcher (CloudData::loadFromFile, CloudData.cpp:86)."""
    lower = filename.lower()
    if lower.endswith(".xyz"):
        return load_cloud_xyz(filename)
    if lower.endswith(".nvdb"):
        return load_cloud_nvdb(filename)
    if lower.endswith((".dat", ".raw")):
        return load_cloud_dat_raw(filename)
    raise ValueError(f"Unknown cloud file extension: {filename}")
