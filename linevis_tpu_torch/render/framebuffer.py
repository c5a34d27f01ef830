"""Framebuffer utilities: sRGB conversion, PNG IO, SSIM (host numpy).

Counterpart of `linevis_tpu/render/framebuffer.py`. SSIM follows Wang et
al. 2004 with an 11x11 Gaussian window.
"""

from __future__ import annotations

import numpy as np

from linevis_tpu_torch.render.transfer_function import linear_to_srgb

__all__ = [
    "to_srgb_u8", "save_png", "load_png", "encode_png", "ssim", "image_mean_difference",
]


def to_srgb_u8(image_linear: np.ndarray) -> np.ndarray:
    """[H, W, 3|4] linear float -> uint8 sRGB."""
    img = np.asarray(image_linear)
    rgb = linear_to_srgb(np.clip(img[..., :3], 0.0, 1.0))
    out = np.clip(np.rint(np.asarray(rgb) * 255.0), 0, 255).astype(np.uint8)
    if img.shape[-1] == 4:
        a = np.clip(np.rint(np.asarray(img[..., 3]) * 255.0), 0, 255).astype(np.uint8)
        out = np.concatenate([out, a[..., None]], axis=-1)
    return out


def save_png(filename: str, image: np.ndarray, assume_linear: bool = True) -> None:
    """Save [H, W, 3|4] image (float linear by default) as PNG."""
    from PIL import Image

    if image.dtype != np.uint8:
        image = to_srgb_u8(image) if assume_linear else np.clip(
            np.rint(image * 255.0), 0, 255
        ).astype(np.uint8)
    Image.fromarray(image).save(filename)


def load_png(filename: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(filename))


def encode_png(image_u8: np.ndarray) -> bytes:
    """[H, W, 3|4] uint8 -> in-memory PNG bytes (the viewer's frame path)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_u8).save(buf, format="PNG")
    return buf.getvalue()


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels (Wang et al. 2004, 11x11 Gaussian window)."""
    from scipy.signal import fftconvolve

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = fftconvolve(x, k, mode="valid")
        mu_y = fftconvolve(y, k, mode="valid")
        xx = fftconvolve(x * x, k, mode="valid") - mu_x**2
        yy = fftconvolve(y * y, k, mode="valid") - mu_y**2
        xy = fftconvolve(x * y, k, mode="valid") - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (xx + yy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def image_mean_difference(a: np.ndarray, b: np.ndarray) -> float:
    """|mean(a) - mean(b)| — the reference's statistical image-equality
    metric (test/TestVolumetricPathTracing.cpp:92-95, tolerance 2e-3)."""
    return float(
        abs(np.asarray(a, np.float64).mean() - np.asarray(b, np.float64).mean())
    )
