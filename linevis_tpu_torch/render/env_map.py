"""Environment-map lighting for the volumetric path tracer.

Counterpart of `linevis_tpu/render/env_map.py` (reference
`VolumetricPathTracingPass.hpp:169-174`, the environment map and its
intensity factor, and the lat-long lookup of `Data/Shaders/Scattering/
Clouds/VptUtils.glsl:129-148`):

    texcoord = (atan(dir.z, dir.x) / TWO_PI + 0.5, -asin(dir.y) / PI + 0.5)

The loader reads Radiance RGBE (.hdr, decoded here) and LDR images through
PIL (imported only when such a file is read; sRGB -> linear), in numpy on the
host. The lookup runs on the directions' device
(`kernels/volume_common.env_map_sample`, whose twin the path tracer's kernel
calls for escaping rays).
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.kernels.volume_common import env_map_sample

__all__ = ["load_environment_map", "sample_env_map"]


def _srgb_to_linear(c: np.ndarray) -> np.ndarray:
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE reader (flat or adaptive-RLE scanlines)."""
    with open(path, "rb") as f:
        raw = f.read()
    if not (raw.startswith(b"#?RADIANCE") or raw.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = raw.find(b"\n\n")
    if pos < 0:
        raise ValueError(f"{path}: missing HDR header terminator")
    dims = raw[pos + 2 : raw.find(b"\n", pos + 2)].split()
    if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {dims}")
    h, w = int(dims[1]), int(dims[3])
    data = raw[raw.find(b"\n", pos + 2) + 1 :]
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if (
            len(data) - off >= 4
            and data[off] == 2
            and data[off + 1] == 2
            and ((data[off + 2] << 8) | data[off + 3]) == w
        ):
            off += 4  # adaptive RLE scanline
            for c in range(4):
                x = 0
                while x < w:
                    count = data[off]
                    off += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = data[off]
                        off += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = np.frombuffer(
                            data, np.uint8, count, off
                        )
                        off += count
                        x += count
        else:  # flat scanline
            row = np.frombuffer(data, np.uint8, w * 4, off)
            rgbe[y] = row.reshape(w, 4)
            off += w * 4
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def load_environment_map(path: str) -> np.ndarray:
    """-> [H, W, 3] float32 LINEAR radiance, equirectangular."""
    if path.lower().endswith(".hdr"):
        return _load_radiance_hdr(path).astype(np.float32)
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return _srgb_to_linear(img).astype(np.float32)


def sample_env_map(env: torch.Tensor, w: torch.Tensor, intensity) -> torch.Tensor:
    """Bilinear lat-long lookup (VptUtils.glsl:136 convention).
    env: [H, W, 3]; w: [..., 3] unit directions -> [..., 3]."""
    return torch.stack(env_map_sample(env, w.unbind(-1), float(intensity)), dim=-1)
