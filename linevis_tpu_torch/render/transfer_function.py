"""Transfer functions: piecewise-linear color + opacity maps.

Counterpart of `linevis_tpu/render/transfer_function.py`. Reference: sgl
`TransferFunctionWindow`, `Data/TransferFunctions/*.xml` (colorspace sRGB,
interpolation in linear RGB; `TransferFunction.from_xml` reads them).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import Sequence, Tuple

import numpy as np
import torch

from linevis_tpu_torch.automation.profiling import span

__all__ = [
    "TransferFunction", "srgb_to_linear", "linear_to_srgb", "tf_eval_points",
    "tf_channels_static", "tf_static_table",
]


def tf_eval_points(color_pts, opacity_pts, x: torch.Tensor):
    """Piecewise-linear TF evaluation from static control points.

    color_pts: tuple of (pos, r, g, b) in LINEAR RGB; opacity_pts: tuple of
    (pos, a). x [...] in [0, 1] -> (rgb [3, ...], alpha [...]).
    """
    rgb = tf_channels_static(color_pts, 3, x)
    return torch.stack(rgb, dim=0), tf_channels_static(opacity_pts, 1, x)[0]


def _tf_segments(pts, nch):
    """The float32 constants of the unrolled TF (the JAX package's
    `tf_eval_points` and OIT kernel's `_tf_channels_static`): the first
    point's values, then per
    segment (p0, p1, span, v0[nch], dv[nch]). span = max(p1 - p0, 1e-9) and
    dv = v1 - v0 are formed in float64 from the points, as Python floats
    are, and rounded to float32 once."""
    f32 = np.float32
    init = [f32(pts[0][1 + c]) for c in range(nch)]
    segs = []
    for k in range(len(pts) - 1):
        p0, p1 = float(pts[k][0]), float(pts[k + 1][0])
        v0 = [f32(pts[k][1 + c]) for c in range(nch)]
        dv = [f32(float(pts[k + 1][1 + c]) - float(pts[k][1 + c])) for c in range(nch)]
        segs.append([f32(p0), f32(p1), f32(max(p1 - p0, 1e-9)), *v0, *dv])
    return init, segs


def tf_static_table(tf_color, tf_opacity) -> np.ndarray:
    """Flat float32 table of both TFs for the CUDA kernels:
    [n_color_points, n_opacity_points, color init[3], color segments
    (p0, p1, span, v0[3], dv[3]) ..., opacity init[1], opacity segments
    (p0, p1, span, v0, dv) ...]."""
    out = [float(len(tf_color)), float(len(tf_opacity))]
    for pts, nch in ((tf_color, 3), (tf_opacity, 1)):
        init, segs = _tf_segments(pts, nch)
        out += init
        for seg in segs:
            out += seg
    return np.asarray(out, np.float32)


def tf_channels_static(pts, nch, x: torch.Tensor):
    """Unrolled piecewise-linear TF over `x` with `_tf_segments`' float32
    constants -> list of nch tensors. Later segments win at shared
    endpoints, as in the unrolled `where` chain of the JAX kernel."""
    init, segs = _tf_segments(pts, nch)
    xc = torch.clamp(x, 0.0, 1.0)
    outs = [torch.full_like(x, float(v)) for v in init]
    for seg in segs:
        with span("tf.segment"):
            p0, p1, width = (float(v) for v in seg[:3])
            v0, dv = seg[3:3 + nch], seg[3 + nch:]
            inside = (xc >= p0) & (xc <= p1)
            # A tensor divisor: on the card PyTorch turns division by a Python
            # scalar into multiplication by its reciprocal, which rounds
            # otherwise than the kernels' IEEE division.
            w = (xc - p0) / torch.full((), width, dtype=x.dtype, device=x.device)
            for c in range(nch):
                outs[c] = torch.where(inside, float(v0[c]) + w * float(dv[c]), outs[c])
    return outs


def srgb_to_linear(c):
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    if isinstance(c, torch.Tensor):
        c = torch.clamp(c, 0.0, 1.0)
        return torch.where(
            c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055
        )
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


@dataclasses.dataclass
class TransferFunction:
    """Piecewise-linear TF: control points + baked LUT.

    `color_points_linear` [Kc, 4] (pos, r, g, b in linear RGB) and
    `opacity_points_np` [Ko, 2] feed `tf_eval_points`; `table` [N, 4] is
    the baked LUT.
    """

    table: np.ndarray  # [N, 4] float32, linear RGB + alpha
    value_range: Tuple[float, float] = (0.0, 1.0)
    color_points_linear: np.ndarray = None  # [Kc, 4]
    opacity_points_np: np.ndarray = None  # [Ko, 2]

    RESOLUTION = 256

    @classmethod
    def from_points(
        cls,
        color_points: Sequence[Tuple[float, float, float, float]],  # (pos, r, g, b) 0-255
        opacity_points: Sequence[Tuple[float, float]] = ((0.0, 1.0), (1.0, 1.0)),
        value_range: Tuple[float, float] = (0.0, 1.0),
    ) -> "TransferFunction":
        n = cls.RESOLUTION
        xs = np.linspace(0.0, 1.0, n)
        cp = np.asarray(color_points, np.float64)
        op = np.asarray(opacity_points, np.float64)
        # Interpolate in linear RGB (reference interpolation_colorspace).
        rgb_lin = srgb_to_linear(cp[:, 1:4] / 255.0)
        table = np.zeros((n, 4), np.float32)
        for ch in range(3):
            table[:, ch] = np.interp(xs, cp[:, 0], rgb_lin[:, ch])
        table[:, 3] = np.interp(xs, op[:, 0], op[:, 1])
        return cls(
            table=table,
            value_range=value_range,
            color_points_linear=np.concatenate(
                [cp[:, :1], rgb_lin], axis=1
            ).astype(np.float32),
            opacity_points_np=op.astype(np.float32),
        )

    @classmethod
    def from_xml(cls, filename: str, value_range=(0.0, 1.0)) -> "TransferFunction":
        """A reference TF file: <ColorPoints> of (position, r, g, b) in
        0-255 sRGB and optional <OpacityPoints> of (position, opacity)."""
        root = ET.parse(filename).getroot()
        color_points = [
            (float(p.get("position")), float(p.get("r")), float(p.get("g")), float(p.get("b")))
            for p in root.find("ColorPoints")
        ]
        ops = root.find("OpacityPoints")
        opacity_points = (
            [(float(p.get("position")), float(p.get("opacity"))) for p in ops]
            if ops is not None
            else [(0.0, 1.0), (1.0, 1.0)]
        )
        return cls.from_points(color_points, opacity_points, value_range)

    @classmethod
    def standard(cls) -> "TransferFunction":
        """The reference's Standard.xml (blue-white-red diverging)."""
        return cls.from_points(
            [
                (0.0, 59, 76, 192),
                (0.25, 144, 178, 254),
                (0.5, 220, 220, 220),
                (0.75, 245, 156, 125),
                (1.0, 180, 4, 38),
            ]
        )

    @classmethod
    def viridis_like(cls) -> "TransferFunction":
        """The reference's Viridis.xml points (inverted viridis ramp)."""
        return cls.from_points(
            [
                (0.0, 252, 229, 30),
                (0.25, 81, 195, 78),
                (0.5, 31, 129, 121),
                (0.75, 45, 62, 120),
                (1.0, 52, 0, 66),
            ]
        )

    def points_arrays(self, device="cpu"):
        """(color [Kc, 4], opacity [Ko, 2]) float32 tensors on `device`."""
        return (
            torch.as_tensor(self.color_points_linear, device=device),
            torch.as_tensor(self.opacity_points_np, device=device),
        )

    def lookup(self, values: torch.Tensor) -> torch.Tensor:
        """Map attribute values [...] -> RGBA [..., 4] (linear RGB): the
        baked LUT sampled with linear interpolation between entries."""
        lo, hi = self.value_range
        t = torch.clamp((values - lo) / max(hi - lo, 1e-9), 0.0, 1.0)
        table = torch.as_tensor(self.table, device=values.device)
        n = table.shape[0]
        f = t * (n - 1)
        i0 = torch.clamp(torch.floor(f).long(), 0, n - 2)
        w = (f - i0)[..., None]
        return table[i0] * (1.0 - w) + table[i0 + 1] * w

    def as_static_points(self):
        """Hashable (color, opacity) point tuples for tf_eval_points."""
        c = tuple(tuple(float(v) for v in row) for row in self.color_points_linear)
        o = tuple(tuple(float(v) for v in row) for row in self.opacity_points_np)
        return c, o
