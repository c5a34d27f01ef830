"""Image denoisers: EAW (a-trous), SVGF (spatial and temporal), spatial hashing.

Counterpart of `linevis_tpu/render/denoiser.py`. Reference denoiser family:
`src/Renderers/Scattering/Denoiser/{EAWDenoiser,SVGF}.{hpp,cpp}`,
`Data/Shaders/Denoiser/{EAWDenoise,SVGF,SH_Denoise}.glsl`, pluggable enum
`Denoiser.hpp:62-99`.
- `eaw_denoise`: edge-avoiding a-trous wavelet filtering (Dammertz et al.
  2010), a 5x5 Gaussian kernel with edge-stopping weights on color,
  position and normal maps (phiColor 5.0, phiPosition 0.1, phiNormal 0.1,
  EAWDenoiser.hpp:85-87), the step width doubling each pass.
- `svgf_denoise`: the spatial SVGF core (Schied et al. 2017), a luminance
  variance that scales the color weight and is filtered with the color.
- `svgf_temporal_denoise`: full SVGF with history reprojection by motion
  vectors, a world-position validity test and moment integration.
- `spatial_hash_denoise`: per-pixel world-space hash cells of
  distance-adaptive size (SH_Denoise.glsl): every pixel reads back the mean
  of its cell.
Plain elementwise PyTorch over [C, H, W] images: each of the 25 taps is a
clamped shift (a gather) and a few fused-size operations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "eaw_denoise", "svgf_denoise", "svgf_temporal_denoise", "SvgfTemporalState",
    "spatial_hash_denoise",
]

_U32 = 0xFFFFFFFF


def _shift2d(img, dy: int, dx: int):
    """Shift [..., H, W] by (dy, dx) with edge clamp."""
    H, W = img.shape[-2], img.shape[-1]
    dev = img.device
    ys = torch.clamp(torch.arange(H, device=dev) + dy, 0, H - 1)
    xs = torch.clamp(torch.arange(W, device=dev) + dx, 0, W - 1)
    return img.index_select(-2, ys).index_select(-1, xs)


def _kernel_weight(x: int, y: int) -> float:
    """exp(-(x^2 + y^2) / 2) of a tap, rounded to float32."""
    return float(np.exp(np.float32(-(x * x + y * y) / 2.0)))


def _eaw_pass(color, position, normal, step: int, phi_color: float, phi_position: float,
              phi_normal: float):
    """One a-trous pass (EAWDenoise.glsl main loop)."""
    acc = torch.zeros_like(color)
    acc_w = torch.zeros(color.shape[-2:], dtype=color.dtype, device=color.device)
    for i in range(25):
        x, y = (i % 5) - 2, (i // 5) - 2
        kv = _kernel_weight(x, y)
        oc = _shift2d(color, y * step, x * step)
        dc = color - oc
        w = torch.clamp(torch.exp(-torch.sum(dc * dc, dim=0) / phi_color), max=1.0)
        if position is not None:
            dp = position - _shift2d(position, y * step, x * step)
            w = w * torch.clamp(torch.exp(-torch.sum(dp * dp, dim=0) / phi_position), max=1.0)
        if normal is not None:
            dn = normal - _shift2d(normal, y * step, x * step)
            w = w * torch.clamp(torch.exp(-torch.sum(dn * dn, dim=0) / phi_normal), max=1.0)
        acc = acc + kv * w[None] * oc
        acc_w = acc_w + kv * w
    return acc / torch.clamp(acc_w, min=1e-8)[None]


def eaw_denoise(
    color: torch.Tensor,  # [C, H, W]
    position: torch.Tensor = None,  # [3, H, W]
    normal: torch.Tensor = None,  # [3, H, W]
    num_iterations: int = 3,
    phi_color: float = 5.0,
    phi_position: float = 0.1,
    phi_normal: float = 0.1,
) -> torch.Tensor:
    """Edge-avoiding a-trous wavelet denoise (EAWDenoiser.cpp:316-320: the
    step width doubles each iteration)."""
    out = color
    step = 1
    for _ in range(num_iterations):
        out = _eaw_pass(out, position, normal, step, phi_color, phi_position, phi_normal)
        step *= 2
    return out


def _luminance(c):
    return 0.2126 * c[0] + 0.7152 * c[1] + 0.0722 * c[2]


def _spatial_variance(color):
    """3x3 luminance moment variance estimate (the spatial fallback)."""
    lum = _luminance(color)
    m1 = torch.zeros_like(lum)
    m2 = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = _shift2d(lum, dy, dx)
            m1 = m1 + v
            m2 = m2 + v * v
    m1 = m1 / 9.0
    m2 = m2 / 9.0
    return torch.clamp(m2 - m1 * m1, min=0.0)


def svgf_denoise(
    color: torch.Tensor,  # [3, H, W]
    position: torch.Tensor = None,
    normal: torch.Tensor = None,
    num_iterations: int = 4,
    phi_color: float = 10.0,
    phi_normal: float = 128.0,
    variance: torch.Tensor = None,  # [H, W] temporally integrated variance
) -> torch.Tensor:
    """Spatial SVGF: the color edge-stopping weight normalized by the
    luminance standard deviation (Schied et al. 2017, eq. 4), filtered with
    the a-trous schedule. `variance` (svgf_temporal_denoise's integrated
    moments) replaces the spatial 3x3 estimate when given."""
    var = _spatial_variance(color) if variance is None else variance
    out = color
    step = 1
    for _ in range(num_iterations):
        sigma = torch.sqrt(var) + 1e-4
        acc = torch.zeros_like(out)
        acc_v = torch.zeros_like(var)
        lum_c = _luminance(out)
        acc_w = torch.zeros_like(lum_c)
        for i in range(25):
            x, y = (i % 5) - 2, (i // 5) - 2
            kv = _kernel_weight(x, y)
            oc = _shift2d(out, y * step, x * step)
            dl = torch.abs(lum_c - _luminance(oc))
            w = torch.exp(-dl / (phi_color * sigma))
            if normal is not None:
                on = _shift2d(normal, y * step, x * step)
                ndot = torch.clamp(torch.sum(normal * on, dim=0), 0.0, 1.0)
                w = w * ndot ** phi_normal
            if position is not None:
                dp = position - _shift2d(position, y * step, x * step)
                w = w * torch.exp(-torch.sum(dp * dp, dim=0) / 0.1)
            acc = acc + kv * w[None] * oc
            acc_v = acc_v + (kv * w) ** 2 * _shift2d(var, y * step, x * step)
            acc_w = acc_w + kv * w
        out = acc / torch.clamp(acc_w, min=1e-8)[None]
        var = acc_v / torch.clamp(acc_w, min=1e-8) ** 2
        step *= 2
    return out


@dataclasses.dataclass
class SvgfTemporalState:
    """Per-pixel history carried between frames (SVGF.hpp:46,92: color and
    moments history, history length, and the previous frame's geometry for
    the reprojection validity test), on the frames' device."""

    color: torch.Tensor  # [3, H, W] temporally integrated color
    moments: torch.Tensor  # [2, H, W] integrated luminance moments
    length: torch.Tensor  # [H, W] history length
    position: torch.Tensor  # [3, H, W] world positions of the previous frame


def _bilinear(img, ys, xs):
    """Sample [C, H, W] at float (ys, xs) [H, W] with edge clamp."""
    H, W = img.shape[-2], img.shape[-1]
    y0 = torch.clamp(torch.floor(ys), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs), 0, W - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i, x0i = y0.long(), x0.long()
    y1i, x1i = torch.clamp(y0i + 1, 0, H - 1), torch.clamp(x0i + 1, 0, W - 1)
    return (
        img[..., y0i, x0i] * ((1 - fy) * (1 - fx))
        + img[..., y0i, x1i] * ((1 - fy) * fx)
        + img[..., y1i, x0i] * (fy * (1 - fx))
        + img[..., y1i, x1i] * (fy * fx)
    )


def svgf_temporal_denoise(
    color: torch.Tensor,  # [3, H, W] this frame's noisy color
    motion: torch.Tensor,  # [2, H, W] screen motion in px (+x right / +y down)
    position: torch.Tensor,  # [3, H, W] world positions (validity + filter)
    state: SvgfTemporalState = None,  # None on the first frame or after a reset
    normal: torch.Tensor = None,
    num_iterations: int = 4,
    phi_color: float = 10.0,
    phi_normal: float = 128.0,
    alpha: float = 0.2,
    moments_alpha: float = 0.2,
    position_tolerance: float = 0.01,
):
    """Full SVGF (Schied et al. 2017; reference SVGF.hpp:46,92):

    1. reproject the history color and moments at (pixel - motion),
       bilinear;
    2. keep it where the reprojected world position lies within
       `position_tolerance` of this frame's (disoccluded pixels restart at
       history length 1);
    3. integrate color and luminance moments exponentially (alpha floor 0.2,
       1/length while the history is shorter than 5);
    4. variance = integrated m2 - m1^2, the spatial 3x3 estimate while the
       history is shorter than 4 frames;
    5. a-trous filter the integrated color (`svgf_denoise`).

    Returns (filtered [3, H, W], new state); pass the state to the next
    frame, None after a camera cut."""
    H, W = color.shape[-2], color.shape[-1]
    dev = color.device
    lum = _luminance(color)
    cur_moments = torch.stack([lum, lum * lum])
    if state is None:
        new_state = SvgfTemporalState(
            color=color, moments=cur_moments,
            length=torch.ones((H, W), dtype=torch.float32, device=dev), position=position,
        )
        out = svgf_denoise(color, position=position, normal=normal,
                           num_iterations=num_iterations, phi_color=phi_color,
                           phi_normal=phi_normal)
        return out, new_state

    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None] - motion[1]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :] - motion[0]
    in_bounds = (ys >= 0) & (ys <= H - 1) & (xs >= 0) & (xs <= W - 1)
    hist_color = _bilinear(state.color, ys, xs)
    hist_moments = _bilinear(state.moments, ys, xs)
    hist_length = _bilinear(state.length[None], ys, xs)[0]
    hist_pos = _bilinear(state.position, ys, xs)
    # Geometry consistency (disocclusion test, SVGF sec. 4.1; absolute world
    # distance: the scenes are normalized to the unit box).
    dpos = torch.sqrt(torch.sum((hist_pos - position) ** 2, dim=0))
    valid = in_bounds & (dpos < position_tolerance)

    length = torch.where(valid, hist_length + 1.0, 1.0)
    a_c = torch.clamp(1.0 / length, min=alpha)
    a_m = torch.clamp(1.0 / length, min=moments_alpha)
    integrated = torch.where(valid[None], hist_color * (1 - a_c)[None] + color * a_c[None], color)
    moments = torch.where(valid[None],
                          hist_moments * (1 - a_m)[None] + cur_moments * a_m[None], cur_moments)
    var_t = torch.clamp(moments[1] - moments[0] * moments[0], min=0.0)
    # Short history -> the spatial variance estimate (paper sec. 4.2).
    var = torch.where(length < 4.0, _spatial_variance(integrated), var_t)
    out = svgf_denoise(integrated, position=position, normal=normal,
                       num_iterations=num_iterations, phi_color=phi_color,
                       phi_normal=phi_normal, variance=var)
    return out, SvgfTemporalState(color=integrated, moments=moments, length=length,
                                  position=position)


def _wang_hash(x):
    """wang_hash (SH_Denoise.glsl:58-66) on uint32 values carried in int64."""
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _U32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _U32
    return x ^ (x >> 15)


def _f2u(f):
    """The bits of float32 values as uint32 values in int64."""
    return f.float().contiguous().view(torch.int32).long() & _U32


def spatial_hash_denoise(
    values: torch.Tensor,  # [H, W] noisy scalar (AO)
    position: torch.Tensor,  # [3, H, W] world positions
    normal: torch.Tensor,  # [3, H, W]
    cam_pos: torch.Tensor,  # [3]
    s_p: float = 4.0,  # coarseness in pixels
    s_min: float = 1e-3,  # smallest cell size
    s_nd: float = 2.0,  # normal quantization
    table_size: int = 1 << 20,
) -> torch.Tensor:
    """Spatial-hashing denoiser (reference SpatialHashingDenoiser.cpp,
    SH_Denoise.glsl): every pixel hashes its world position, quantized at a
    distance-adaptive power-of-two cell size (`s_wd_calc`, glsl:199-205),
    and its quantized normal (`H7D`, glsl:132-141) into a table; each pixel
    reads back the mean of its entry. The write pass is a scatter-add into
    (sum, count) (`index_add_`; on the card its float sums are taken in no
    fixed order), the read pass a gather; colliding cells average."""
    H, W = values.shape
    dev = values.device
    dis = torch.sqrt(torch.sum((position - cam_pos[:, None, None]) ** 2, dim=0))
    s_w = dis * torch.tan(torch.tensor(np.float32(s_p) / np.float32(H), device=dev))
    log_step = torch.floor(torch.log2(torch.clamp(s_w / s_min, min=1.0)))
    s_wd = torch.exp2(log_step) * s_min
    cell = torch.floor(position / s_wd[None])
    nrm = torch.sqrt(torch.sum(normal * normal, dim=0, keepdim=True))
    nq = torch.trunc(normal / torch.clamp(nrm, min=1e-9) * s_nd)
    h = _wang_hash((_f2u(cell[0]) + _wang_hash(
        (_f2u(cell[1]) + _wang_hash((_f2u(cell[2]) + _f2u(s_wd)) & _U32)) & _U32)) & _U32)
    for c in range(3):
        h = _wang_hash((_f2u(nq[c]) + h) & _U32)
    idx = (h % table_size).reshape(-1)
    sums = torch.zeros(table_size, dtype=torch.float32, device=dev).index_add_(
        0, idx, values.reshape(-1).float())
    counts = torch.zeros(table_size, dtype=torch.float32, device=dev).index_add_(
        0, idx, torch.ones(H * W, dtype=torch.float32, device=dev))
    return (sums[idx] / torch.clamp(counts[idx], min=1.0)).reshape(H, W)

