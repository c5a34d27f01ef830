"""Multi-variable line rendering (per-attribute transfer functions).

Counterpart of `linevis_tpu/render/multivar.py` (the reference's multi-var
mode, `LineDataFlow.hpp:185-203` with `MultiVarTransferFunctionWindow`;
shading `Renderers/MultiVar/MultiVar.glsl`): the tube circumference is
split into K angular sectors, sector k coloured by attribute k through its
own transfer function. The K transfer functions are concatenated into one
over [0, 1] (TF_k on [k/K, (k+1)/K)) and each ring vertex carries the
packed attribute (k + attr_k) / K, so the tube mesh draws in one pass of
the triangle raster (kernel B3 on the card,
`render/opaque.py:render_opaque_image`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import vdiv
from linevis_tpu_torch.render.transfer_function import TransferFunction

__all__ = [
    "MultiVarTransferFunctions",
    "combine_transfer_functions",
    "combine_transfer_function_table",
    "build_multivar_tube_mesh",
]


class MultiVarTransferFunctions:
    """Per-attribute TFs (MultiVarTransferFunctionWindow role)."""

    def __init__(self, tfs: List[TransferFunction]):
        self.tfs = list(tfs)

    @classmethod
    def default(cls, k: int) -> "MultiVarTransferFunctions":
        return cls([TransferFunction.standard() for _ in range(k)])

    def __len__(self):
        return len(self.tfs)


def combine_transfer_functions(mv: MultiVarTransferFunctions):
    """-> (tf_color, tf_opacity) static points with TF_k compressed into
    [k/K, (k+1)/K). Sector boundaries become step discontinuities (two
    control points at nearly the same position)."""
    K = len(mv)
    eps = 1e-5 / K
    color_pts, opacity_pts = [], []
    for k, tf in enumerate(mv.tfs):
        c_pts, o_pts = tf.as_static_points()
        lo = k / K
        span = 1.0 / K

        def pack(pts, lo=lo, span=span, k=k):
            packed = []
            for j, p in enumerate(pts):
                x = lo + p[0] * span
                if j == 0 and k > 0:
                    x += eps  # sharp sector boundary
                if j == len(pts) - 1 and k < K - 1:
                    x -= eps
                packed.append((x,) + tuple(p[1:]))
            return packed

        color_pts += pack(c_pts)
        opacity_pts += pack(o_pts)
    return tuple(color_pts), tuple(opacity_pts)


def combine_transfer_function_table(mv: MultiVarTransferFunctions) -> TransferFunction:
    """The combined TF as a baked LUT (for the triangle G-buffer path, which
    samples `TransferFunction.table`): sector k's table occupies rows
    [k N, (k+1) N)."""
    return TransferFunction(table=np.concatenate([tf.table for tf in mv.tfs], axis=0))


def build_multivar_tube_mesh(
    positions,  # [L, P, 3]
    mask,  # [L, P]
    attrs_list: Sequence[np.ndarray],  # K arrays [L, P], each in [0, 1]
    radius: float = 0.001,
    num_subdivisions: int = 8,
    device="cuda",
):
    """Tube mesh on `device` whose ring sectors carry packed per-attribute
    values; draw it with the combined TF."""
    from linevis_tpu_torch.geometry.tubes import build_tube_triangle_mesh

    K = len(attrs_list)
    S = int(num_subdivisions)
    mesh = build_tube_triangle_mesh(positions, mask, attrs_list[0], radius=radius,
                                    num_subdivisions=S, device=device)
    sector = (np.arange(S) * K) // S  # attribute index per subdivision
    packed = torch.stack([
        vdiv(int(sector[s]) + torch.clamp(torch.as_tensor(
            np.asarray(attrs_list[sector[s]], np.float32), device=device), 0.0, 1.0 - 1e-6), K)
        for s in range(S)], dim=0)  # [S, L, P]
    return dataclasses.replace(mesh, attrs=packed)
