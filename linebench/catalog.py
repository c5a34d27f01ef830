"""Find a cell's parts by name.

A cell `<config>.<traffic>` is `workloads/<cell>.json`: it names its
configuration (`configs/<config>.json`: the deployment's sizes and the
input maker, `inputs/<inputs>.py`) and its traffic (`traffic/<traffic>.json`:
the rendering mode, its settings, the camera flight and the reference,
`reference/<reference>.py`), holds the limits of the numbers its
correctness check compares, and names the end-to-end metrics it reports.
Hand-written kernels are `kernels/<kernel>.json` (the names their launches
carry in a device trace), per-layer metrics `metrics/<metric>.py`. Adding
any of them is adding a file.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _json(kind: str, name: str) -> dict:
    if not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r}")
    path = os.path.join(HERE, kind, name + ".json")
    if not os.path.exists(path):
        raise ValueError(f"no {kind} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list


def cell(name: str) -> Cell:
    w = _json("workloads", name)
    return Cell(name=name, config=_json("configs", w["config"]),
                traffic=_json("traffic", w["traffic"]), limits=dict(w["limits"]),
                chips=int(w.get("chips", 1)), end_to_end=list(w["end_to_end"]))


def inputs_maker(config: dict):
    return importlib.import_module(f"linebench.inputs.{config['inputs']}").Inputs


def reference(traffic: dict):
    return importlib.import_module(f"linebench.reference.{traffic['reference']}")


def names(kind: str, ext: str):
    d = os.path.join(HERE, kind)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def kernels() -> dict:
    """{kernel: its file's contents}; "trace_names" are the names of its
    launches in a device trace."""
    return {k: _json("kernels", k) for k in names("kernels", ".json")}


def metrics() -> dict:
    """{metric: its reader module} (`read(run) -> value or None`, `UNIT`)."""
    return {m: importlib.import_module(f"linebench.metrics.{m}")
            for m in names("metrics", ".py") if m != "__init__"}
