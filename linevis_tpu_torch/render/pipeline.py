"""Render pipeline configuration.

Counterpart of `linevis_tpu/render/pipeline.py`; this slice of the port
carries only `RasterSettings` (the triangle vertex stage and plane payloads
come with the triangle raster).
"""

from __future__ import annotations

import dataclasses

__all__ = ["RasterSettings"]


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static raster configuration."""

    width: int = 800
    height: int = 600
    tile_w: int = 16
    tile_h: int = 8
    # Padding columns appended to the sorted pair payload (layout contract
    # shared with the JAX package; the CUDA kernels bounds-check instead).
    chunk: int = 128
    span_x: int = 2
    span_y: int = 2
    background_color: tuple = (1.0, 1.0, 1.0, 1.0)
    depth_cue_strength: float = 0.0
    # Analytic coverage AA on the opaque capsule raster (the reference's
    # MSAA role). Off: exact binary hit test.
    aa: bool = True
    # Transfer function as static control points (pos, r, g, b linear RGB)
    # and (pos, alpha). Defaults to the reference's Standard.xml map.
    tf_color: tuple = (
        (0.0, 0.04373503, 0.07227185, 0.52711511),
        (0.25, 0.27889428, 0.44520119, 0.9911021),
        (0.5, 0.71569347, 0.71569347, 0.71569347),
        (0.75, 0.91309863, 0.33245152, 0.20507874),
        (1.0, 0.45641103, 0.00121411, 0.01938236),
    )
    tf_opacity: tuple = ((0.0, 1.0), (1.0, 1.0))
