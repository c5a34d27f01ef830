"""`datasets.json` registry parser.

Counterpart of `linevis_tpu/loaders/dataset_list.py`.

Reference: `src/Loaders/DataSetList.{hpp:52-83,cpp:61-190}` and the JSON
format documented at `README.md:116-137`. Nested `node` entries form a tree;
leaves carry type flow/stress/trimesh, filenames, optional linewidth,
transform string, attribute names, format version and stress extras.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from linevis_tpu_torch.core.transforms import parse_transform_string

DATA_SET_TYPE_NODE = "node"
DATA_SET_TYPE_FLOW_LINES = "flow"
DATA_SET_TYPE_STRESS_LINES = "stress"
DATA_SET_TYPE_TRIANGLE_MESH = "trimesh"


@dataclasses.dataclass
class DataSetInformation:
    type: str = DATA_SET_TYPE_FLOW_LINES
    name: str = ""
    filenames: List[str] = dataclasses.field(default_factory=list)
    # Optional metadata
    line_width: Optional[float] = None
    transform: Optional[np.ndarray] = None  # 4x4
    version: int = 1
    attribute_names: List[str] = dataclasses.field(default_factory=list)
    height_scale: float = 1.0
    # Stress extras
    mesh_filename: Optional[str] = None
    degenerate_points_filename: Optional[str] = None
    line_hierarchy_filenames: List[str] = dataclasses.field(default_factory=list)
    children: List["DataSetInformation"] = dataclasses.field(default_factory=list)

    def flat_leaves(self) -> List["DataSetInformation"]:
        if self.type != DATA_SET_TYPE_NODE:
            return [self]
        out: List[DataSetInformation] = []
        for c in self.children:
            out.extend(c.flat_leaves())
        return out


_STRESS_V3_DEFAULT_ATTRS = [
    "Principal Stress",
    "Principal Stress Magnitude",
    "von Mises Stress",
    "Normal Stress (xx)",
    "Normal Stress (yy)",
    "Normal Stress (zz)",
    "Shear Stress (yz)",
    "Shear Stress (zx)",
    "Shear Stress (xy)",
]


def _resolve(path: str, base_dir: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base_dir, path)


def _parse_node(source: dict, base_dir: str) -> DataSetInformation:
    info = DataSetInformation(type=source.get("type", DATA_SET_TYPE_FLOW_LINES))
    info.name = source.get("name", "")
    if info.type == DATA_SET_TYPE_NODE:
        info.children = [_parse_node(c, base_dir) for c in source.get("children", [])]
        return info

    filenames = source.get("filenames", [])
    if isinstance(filenames, str):
        filenames = [filenames]
    info.filenames = [_resolve(f, base_dir) for f in filenames]

    if "linewidth" in source:
        info.line_width = float(source["linewidth"])
    if "transform" in source:
        info.transform = parse_transform_string(source["transform"])
    elif info.type == DATA_SET_TYPE_STRESS_LINES:
        # Stress default: rotate(270°, 1, 0, 0) (DataSetList.cpp:118-121)
        info.transform = parse_transform_string("rotate(270°, 1, 0, 0)")
    if "version" in source:
        info.version = int(source["version"])
    attrs = source.get("attributes")
    if attrs is not None:
        info.attribute_names = [attrs] if isinstance(attrs, str) else list(attrs)
    elif info.type == DATA_SET_TYPE_STRESS_LINES and info.version >= 3:
        info.attribute_names = list(_STRESS_V3_DEFAULT_ATTRS)
    if "heightscale" in source:
        info.height_scale = float(source["heightscale"])
    if "mesh" in source:
        info.mesh_filename = _resolve(source["mesh"], base_dir)
    if "degenerate_points" in source:
        info.degenerate_points_filename = _resolve(source["degenerate_points"], base_dir)
    lh = source.get("line_hierarchy")
    if lh is not None:
        lh = [lh] if isinstance(lh, str) else list(lh)
        info.line_hierarchy_filenames = [_resolve(f, base_dir) for f in lh]
    return info


def load_dataset_list(filename: str) -> DataSetInformation:
    """Parses datasets.json -> root node with children."""
    with open(filename, "r") as f:
        doc = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(filename))
    root = DataSetInformation(type=DATA_SET_TYPE_NODE, name="Root")
    root.children = [_parse_node(c, base_dir) for c in doc.get("datasets", [])]
    return root
