"""NetCDF trajectory loader, in numpy.

Counterpart of `linevis_tpu/loaders/netcdf_lines.py`.

Mirrors `src/Loaders/NetCdfLineLoader.cpp:360-465` `loadNetCdfFile`: reads
CF-style trajectory files with dimensions (ensemble, trajectory, time) and
variables `time`, `lon`, `lat`, `pressure` plus any further 3-D float
variables (display name from their `standard_name` attribute).  Positions
are mapped lat -> x, normalized log pressure -> y, lon -> z
(`convertLatLonToCartesian`, NetCdfLineLoader.cpp:248-320); points with
NaN or non-positive pressure are skipped before the first valid sample
and truncate the trajectory after it.

No netcdf-c binding: NetCDF classic (CDF-1/2) goes through
`scipy.io.netcdf_file`, NetCDF-4 (HDF5 container) through `h5py`, imported
only for such a file.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from linevis_tpu_torch.core.trajectories import RaggedTrajectories

__all__ = ["load_trajectories_from_netcdf"]

_BLACKLIST = {"time", "lon", "lat", "ensemble", "trajectory"}


def _read_netcdf_variables(filename: str):
    """-> (vars {name: np.ndarray [trajectory, time]}, attr_names {name:
    display}) for all 3-D float variables + lon/lat/pressure."""
    try:
        from scipy.io import netcdf_file

        f = netcdf_file(filename, "r", mmap=False)
        try:
            out: Dict[str, np.ndarray] = {}
            display: Dict[str, str] = {}
            for name, var in f.variables.items():
                data = np.asarray(var[:])
                if data.ndim == 3 and data.dtype.kind == "f":
                    out[name] = data.reshape(data.shape[-2], data.shape[-1])
                    std = getattr(var, "standard_name", None)
                    if isinstance(std, bytes):
                        std = std.decode()
                    display[name] = std or name
            return out, display
        finally:
            f.close()
    except Exception:
        pass

    import h5py

    out = {}
    display = {}
    with h5py.File(filename, "r") as f:
        for name in f.keys():
            ds = f[name]
            if not hasattr(ds, "shape"):
                continue
            data = np.asarray(ds)
            if data.ndim == 3 and data.dtype.kind == "f":
                out[name] = data.reshape(data.shape[-2], data.shape[-1])
                std = ds.attrs.get("standard_name")
                if isinstance(std, bytes):
                    std = std.decode()
                display[name] = std or name
    return out, display


def load_trajectories_from_netcdf(filename: str) -> RaggedTrajectories:
    variables, display = _read_netcdf_variables(filename)
    for required in ("lon", "lat", "pressure"):
        if required not in variables:
            raise ValueError(
                f"{filename}: missing NetCDF variable {required!r} "
                f"(found {sorted(variables)})"
            )
    lon = variables["lon"].astype(np.float32)
    lat = variables["lat"].astype(np.float32)
    pressure = variables["pressure"].astype(np.float32)
    n_traj, n_time = pressure.shape

    pos_mask = np.isfinite(pressure) & (pressure > 0.0)
    min_p = pressure[pos_mask].min() if pos_mask.any() else 1.0
    max_p = np.nanmax(pressure) if np.isfinite(pressure).any() else 1.0
    log_min = np.log(max(min_p, 1e-30))
    log_max = np.log(max(max_p, 1e-30))
    denom = log_min - log_max if log_min != log_max else 1.0

    # Reference keeps 'pressure' as a regular attribute too (it is not in
    # the blacklist, NetCdfLineLoader.cpp:398-400).
    attr_vars = [n for n in sorted(variables) if n not in _BLACKLIST]

    positions: List[np.ndarray] = []
    attributes: List[np.ndarray] = []
    for tr in range(n_traj):
        valid = pos_mask[tr]
        # Skip leading invalid samples; truncate at the first invalid
        # sample after valid data (NetCdfLineLoader.cpp:292-301).
        idx = np.nonzero(valid)[0]
        if len(idx) == 0:
            sel = np.zeros((0,), np.int64)
        else:
            start = idx[0]
            after = np.nonzero(~valid[start:])[0]
            stop = start + (after[0] if len(after) else n_time - start)
            sel = np.arange(start, stop)
        p = pressure[tr, sel]
        norm_log_p = (np.log(np.maximum(p, 1e-30)) - log_max) / denom
        pos = np.stack(
            [lat[tr, sel], norm_log_p, lon[tr, sel]], axis=-1
        ).astype(np.float32)
        positions.append(pos)
        attributes.append(np.stack(
            [variables[n][tr, sel].astype(np.float32) for n in attr_vars],
            axis=0,
        ) if attr_vars else np.zeros((0, len(sel)), np.float32))

    return RaggedTrajectories(
        positions=positions,
        attributes=attributes,
        attribute_names=[display.get(n, n) for n in attr_vars],
    )
