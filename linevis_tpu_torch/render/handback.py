"""The frame's hand-back: a rendered image on its device -> numpy in host
memory, as every registry mode returns it.

Three spans cover it while a profiler records (`automation/profiling.py`):
`handback.wait`, an explicit wait for the device's queued work (issued only
then: without it the copy waits for the same work, so the device does the
same either way), `handback.copy`, the copy to host memory, and
`handback.host`, the host's work on the copy (the channel move and the box
filter of a supersampled frame).
"""

from __future__ import annotations

import numpy as np
import torch

from linevis_tpu_torch.automation.profiling import span, tracing

__all__ = ["hand_back"]


def hand_back(img: torch.Tensor, supersample: int = 1, channels_first: bool = True) -> np.ndarray:
    """[C, H, W] (or, with `channels_first` False, [H, W, C]) image ->
    numpy [H / k, W / k, C], each pixel the mean of its k x k samples for
    `supersample` k."""
    if tracing():
        with span("handback.wait"):
            if img.is_cuda:
                torch.cuda.current_stream(img.device).synchronize()
    with span("handback.copy"):
        out = img.cpu().numpy()
    with span("handback.host"):
        if channels_first:
            out = np.moveaxis(out, 0, -1)
        if supersample > 1:
            k = supersample
            h, w, c = out.shape
            out = out.reshape(h // k, k, w // k, k, c).mean(axis=(1, 3))
    return out
