"""Flow trajectory load dispatcher.

Counterpart of `linevis_tpu/loaders/flow_file.py`.

Mirrors `loadFlowTrajectoriesFromFile` (`src/Loaders/TrajectoryFile.cpp:634+`):
extension dispatch (.obj / .binlines / .nc), optional vertex transform,
position normalization to the unit box and per-attribute min-max
normalization.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from linevis_tpu_torch.core.trajectories import (
    RaggedTrajectories,
    Trajectories,
    normalize_attributes,
    normalize_trajectories,
    pad_trajectories,
)
from linevis_tpu_torch.core.transforms import apply_transform
from linevis_tpu_torch.loaders.binlines import BinLinesData, load_trajectories_from_binlines
from linevis_tpu_torch.loaders.obj_loader import load_trajectories_from_obj


def load_flow_trajectories_from_file(
    filename: str,
    normalize_positions: bool = True,
    normalize_attrs: bool = True,
    transform: Optional[np.ndarray] = None,
    max_points: Optional[int] = None,
) -> Trajectories:
    lower = filename.lower()
    vertices_normalized = False
    if lower.endswith(".obj"):
        ragged = load_trajectories_from_obj(filename)
    elif lower.endswith(".binlines"):
        data: BinLinesData = load_trajectories_from_binlines(filename)
        ragged = data.trajectories
        vertices_normalized = data.vertices_normalized
    elif lower.endswith(".nc"):
        from linevis_tpu_torch.loaders.netcdf_lines import (
            load_trajectories_from_netcdf,
        )

        ragged = load_trajectories_from_netcdf(filename)
    else:
        raise ValueError(f"Unknown line file extension: {filename}")

    if transform is not None:
        ragged = RaggedTrajectories(
            positions=[apply_transform(transform, p) for p in ragged.positions],
            attributes=ragged.attributes,
            attribute_names=ragged.attribute_names,
        )
    traj = pad_trajectories(ragged, max_points=max_points)
    if normalize_positions and not vertices_normalized:
        traj = normalize_trajectories(traj)
    if normalize_attrs:
        traj = normalize_attributes(traj)
    if not traj.attribute_names:
        # Default attribute names "Attribute #i" (LineDataFlow.cpp:496).
        traj.attribute_names = [
            f"Attribute #{i + 1}" for i in range(traj.num_attributes)
        ]
    return traj
