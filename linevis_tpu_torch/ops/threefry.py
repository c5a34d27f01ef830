"""jax.random's sample stream in PyTorch: Threefry-2x32 keys and uniforms.

The JAX package draws every sample of its scattering tracer and path tracer
from `jax.random` (the threefry2x32 implementation, with
`jax_threefry_partitionable` on). The port computes the same stream, so a
key gives the same samples on the card, on the CPU and in the JAX package:

    PRNGKey(s)         = (0, s mod 2^32)
    split(key, n)[i]   = threefry2x32(key, (0, i))         (x0, x1) as the key
    bits(key, shape)   = x0 ^ x1 of threefry2x32(key, (0, i)), i the flat index
    uniform(key, shape)= bitcast_f32((bits >> 9) | 0x3f800000) - 1

Threefry-2x32 is 20 rounds (rotations 13, 15, 26, 6 / 17, 29, 16, 24) with a
key injection every 4 rounds, k2 = k0 ^ k1 ^ 0x1BD11BDA. The uint32
arithmetic runs in int64 masked to 32 bits (torch's uint32 tensors lack
shifts and adds on some devices). `kernels/csrc/threefry.cuh` is the same
function on the card.

A key is an int64 tensor [..., 2] of values in [0, 2^32); the functions
below broadcast over its leading dimensions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = [
    "prng_key", "threefry2x32", "split", "split_at", "bits", "uniform", "uniform_at",
    "bits_to_uniform",
]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` -> int64 [2]."""
    return torch.tensor([0, int(seed) & _M], dtype=torch.int64, device=device)


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
