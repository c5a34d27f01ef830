"""Dataset -> scene-object factory (MainApp::loadLineDataSet role).

Counterpart of `linevis_tpu/scene/factory.py`. Mirrors
`src/MainApp.cpp:2307-2430`: resolve a `DataSetInformation` (from
datasets.json) to the right LineData subclass, apply the transform and
dataset defaults (line width), attach stress extras (hierarchy files,
degenerate points)."""

from __future__ import annotations

from typing import Union

from linevis_tpu_torch.loaders.dataset_list import (
    DATA_SET_TYPE_FLOW_LINES,
    DATA_SET_TYPE_STRESS_LINES,
    DataSetInformation,
)

__all__ = ["load_line_data"]


def load_line_data(info: Union[DataSetInformation, str], base_dir: str = ""):
    """DataSetInformation (or a bare filename) -> LineData subclass
    (LineDataFlow, LineDataStress) or TriangleMeshData. The scene objects
    hold host arrays; their getters and the renderers put them on a
    device."""
    import os

    import numpy as np

    if isinstance(info, str):
        lower = info.lower()
        if lower.endswith((".obj", ".binlines", ".nc")) and not _is_surface(
            info
        ):
            info = DataSetInformation(
                type=DATA_SET_TYPE_FLOW_LINES, filenames=[info], name=info
            )
        elif lower.endswith(".dat"):
            info = DataSetInformation(
                type=DATA_SET_TYPE_STRESS_LINES, filenames=[info], name=info,
                version=3,
            )
        elif lower.endswith(".stl") or (
            lower.endswith(".obj") and _is_surface(info)
        ):
            info = DataSetInformation(
                type="triangle_mesh", filenames=[info], name=info
            )
        else:
            raise ValueError(f"Cannot infer dataset type for {info!r}")

    paths = [os.path.join(base_dir, f) for f in info.filenames]

    if info.type == DATA_SET_TYPE_FLOW_LINES:
        from linevis_tpu_torch.scene.line_data import LineDataFlow

        data = LineDataFlow.load_from_file(
            paths[0], name=info.name, transform=info.transform,
            attribute_names=info.attribute_names or None,
        )
    elif info.type == DATA_SET_TYPE_STRESS_LINES:
        from linevis_tpu_torch.scene.line_data_stress import LineDataStress

        hier = [os.path.join(base_dir, f)
                for f in info.line_hierarchy_filenames]
        data = LineDataStress.load_from_dat(
            paths, version=info.version,
            filenames_hierarchy=hier,
            transform=info.transform, name=info.name,
        )
        if info.degenerate_points_filename:
            from linevis_tpu_torch.loaders.stress_dat import (
                load_degenerate_points_dat,
            )

            data.degenerate_points = np.asarray(load_degenerate_points_dat(
                os.path.join(base_dir, info.degenerate_points_filename)
            ), np.float32)
    elif info.type in ("triangle_mesh", "trimesh"):
        from linevis_tpu_torch.scene.triangle_mesh_data import TriangleMeshData

        data = TriangleMeshData.load_from_file(paths[0], name=info.name)
        return data
    else:
        raise ValueError(f"Unknown dataset type {info.type!r}")

    if info.line_width is not None:
        data.set_line_width(info.line_width)
    return data


def _is_surface(filename: str) -> bool:
    """An .obj is a surface mesh if it has faces ('f ') but no lines."""
    if not filename.lower().endswith(".obj"):
        return False
    try:
        with open(filename) as f:
            head = f.read(65536)
        return "\nf " in head and "\nl " not in head
    except OSError:
        return False
