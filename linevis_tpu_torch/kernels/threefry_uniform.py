"""jax.random.uniform for a key on the card (kernel R6).

`threefry_uniform(key, shape)` is `jax.random.uniform(key, shape)`: the
float32 uniforms of threefry2x32 under `key` at the flat indices of
`shape`; with `split=j`, `jax.random.uniform(jax.random.split(key)[j],
shape)`. On a CUDA key it launches `csrc/threefry_uniform.cu` (one thread
an element, the key read from device memory, the split derived there) and
counts the launch in `threefry_uniform.launches`; on a CPU key it runs the
plain version, `ops/threefry.py`'s `uniform` (of `split_at(key, j)`). The
two agree bit for bit, and both equal jax.random's draws.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from linevis_tpu_torch.kernels import _build
from linevis_tpu_torch.ops import threefry

__all__ = ["threefry_uniform"]


def _launcher():
    fn = _build.load("threefry_uniform").threefry_uniform_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def threefry_uniform(key: torch.Tensor, shape: Sequence[int] = (),
                     split: Optional[int] = None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`, or with `split=j` the uniforms of
    `split(key)[j]`, on the key's device: key int64 [2] -> float32 [*shape]
    in [0, 1)."""
    if key.device.type == "cpu":
        return threefry.uniform(key if split is None else threefry.split_at(key, split), shape)
    if key.device.type != "cuda":
        raise ValueError(f"threefry_uniform: unsupported device {key.device}")
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError("threefry_uniform takes one key: an int64 tensor [2]")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    if n >= 2**32:
        raise ValueError("threefry_uniform: at most 2^32 - 1 elements")
    if split is not None and not 0 <= split < 2**31:
        raise ValueError("threefry_uniform: split must be in [0, 2^31)")
    k = key.contiguous()
    out = torch.empty(shape, dtype=torch.float32, device=key.device)
    with torch.cuda.device(key.device):
        rc = _launcher()(k.data_ptr(), -1 if split is None else split, n, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"threefry_uniform kernel launch failed: CUDA error {rc}")
    threefry_uniform.launches += 1
    return out


threefry_uniform.launches = 0
