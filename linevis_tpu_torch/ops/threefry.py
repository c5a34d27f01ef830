"""jax.random's sample stream in PyTorch: Threefry-2x32 keys and uniforms.

The JAX package draws every sample of its scattering tracer and path tracer
from `jax.random` (the threefry2x32 implementation, with
`jax_threefry_partitionable` on). The port computes the same stream, so a
key gives the same samples on the card, on the CPU and in the JAX package:

    PRNGKey(s)         = (0, s mod 2^32)
    split(key, n)[i]   = threefry2x32(key, (0, i))         (x0, x1) as the key
    fold_in(key, d)    = threefry2x32(key, (0, d))         (the sharded paths' key of rank d)
    bits(key, shape)   = x0 ^ x1 of threefry2x32(key, (0, i)), i the flat index
    uniform(key, shape)= bitcast_f32((bits >> 9) | 0x3f800000) - 1
    normal(key, shape) = sqrt(2) erf_inv(max(lo, 2 uniform(key, shape) + lo)),
                         lo = nextafter(-1, 0), erf_inv XLA's float32 polynomial

Threefry-2x32 is 20 rounds (rotations 13, 15, 26, 6 / 17, 29, 16, 24) with a
key injection every 4 rounds, k2 = k0 ^ k1 ^ 0x1BD11BDA. The uint32
arithmetic runs in int64 masked to 32 bits (torch's uint32 tensors lack
shifts and adds on some devices). `kernels/csrc/threefry.cuh` is the same
function on the card.

A key is an int64 tensor [..., 2] of values in [0, 2^32); the functions
below broadcast over its leading dimensions. `kernels/threefry_uniform.py`
(kernel R6) draws `uniform` on the card for a key held there; `uniform`
here is its plain version.

`normal` is jax.random's `_normal_real`. Its `erf_inv` is the float32
polynomial (M. Giles) that XLA lowers `lax.erf_inv` to, with each Horner
step one fused multiply-add as XLA:CPU contracts it; XLA's own `log1p`
is not correctly rounded, and this one is, so 1% of draws land 1-3 ulps
from jax.random.normal's (tests/test_torch_draws.py measures it).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "prng_key", "threefry2x32", "fold_in", "split", "split_at", "bits", "uniform", "uniform_at",
    "bits_to_uniform", "erf_inv", "normal",
]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` -> int64 [2] on `device`, made there by
    fills: no copy from the host, which on the card would wait for the
    stream's queued work."""
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1:].fill_(int(seed) & _M)
    return key


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter (c0, c1) under the key (k0, k1), all
    int64 in [0, 2^32) (tensors or ints, broadcast) -> (x0, x1) on the key's
    device, in int64 tensors masked to 32 bits."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (k0 + c0) & _M
    x1 = (k1 + c1) & _M
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    for i in range(5):
        for r in _ROT[i % 2]:
            x0.add_(x1).bitwise_and_(_M)
            t = (x1 << r).bitwise_and_(_M)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M)
    return x0, x1


def _counter(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def split_at(key: torch.Tensor, i) -> torch.Tensor:
    """`jax.random.split(key, n)[i]` for any n > i (the counter is i):
    key [..., 2], i an int or an int64 tensor broadcasting with key[..., 0]
    -> [..., 2]."""
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, i)
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for data in [0, 2^32): the key
    threefry2x32(key, (0, data)), as jax.random seeds the counter with
    `threefry_seed(data)` = (0, data). key [..., 2] -> [..., 2] on the key's
    device."""
    data = int(data)
    if not 0 <= data < 2**32:
        raise ValueError(f"fold_in: data {data} outside [0, 2^32)")
    return split_at(key, data)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)`: key [..., 2] -> [..., n, 2]."""
    c = _counter(n, key)
    x0, x1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, c)
    return torch.stack([x0, x1], dim=-1)


def bits(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32 values in int64): key [..., 2]
    -> [..., *shape]."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    lead = key.shape[:-1]
    c = _counter(n, key)
    x0, x1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, c)
    return (x0 ^ x1).reshape(tuple(lead) + shape)


def bits_to_uniform(b: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 uniforms in [0, 1), as jax.random."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.uniform(key, shape)` (float32 in [0, 1)): key [..., 2]
    -> [..., *shape]."""
    return bits_to_uniform(bits(key, shape))


def uniform_at(key: torch.Tensor, i=0) -> torch.Tensor:
    """Element i of `jax.random.uniform(key, shape)` for a shape of more than
    i elements: key [..., 2] -> [...]."""
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, i)
    return bits_to_uniform(x0 ^ x1)


# XLA's float32 erf_inv (chlo.erf_inv's lowering): w = -log1p(-x^2), then a
# degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x.
_ERF_INV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv as XLA evaluates it; each rounding is the same on
    every device (log1p and the fused multiply-adds in float64, rounded)."""
    x = x.to(torch.float32)
    w = (-torch.log1p(-(x * x).double())).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()

    def coefficient(i):  # float32, as XLA holds the constants
        return torch.where(lt, _ERF_INV_LT5[i], _ERF_INV_GE5[i]).float()

    p = coefficient(0)
    for i in range(1, len(_ERF_INV_LT5)):
        p = (p.double() * w + coefficient(i).double()).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal(key: torch.Tensor, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal(key, shape)` (float32): a uniform on
    [nextafter(-1, 0), 1) (2u + lo, exact but the add) through
    sqrt(2) erf_inv; within 3 ulps of jax.random's draw (see `erf_inv`)."""
    u = torch.clamp(uniform(key, shape) * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2_F32 * erf_inv(u)
