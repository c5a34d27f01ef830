"""jax.random's threefry2x32 stream in plain PyTorch, for the references.

A frozen copy of the stream the port draws its samples from: a key is an
int64 tensor [..., 2] of values in [0, 2^32), and

    PRNGKey(s)         = (0, s mod 2^32)
    split(key, n)[i]   = threefry2x32(key, (0, i))
    uniform(key)[i]    = bitcast_f32(((x0 ^ x1) >> 9) | 0x3f800000) - 1,
                         (x0, x1) = threefry2x32(key, (0, i))

Threefry-2x32 is 20 rounds (rotations 13, 15, 26, 6 / 17, 29, 16, 24) with
a key injection every 4 rounds, k2 = k0 ^ k1 ^ 0x1BD11BDA; the uint32
arithmetic runs in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int, device) -> torch.Tensor:
    key = torch.zeros(2, dtype=torch.int64, device=device)
    key[1:].fill_(int(seed) & _M)
    return key


def threefry2x32(k0, k1, c0, c1):
    """(x0, x1) of the counter (c0, c1) under the key (k0, k1)."""
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


def split_at(key: torch.Tensor, i) -> torch.Tensor:
    """`split(key, n)[i]` for any n > i; i an int or an int64 tensor."""
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, i)
    return torch.stack([x0, x1], dim=-1)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """key [..., 2] -> [..., n, 2]."""
    c = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, c)
    return torch.stack([x0, x1], dim=-1)


def bits_to_uniform(b: torch.Tensor) -> torch.Tensor:
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_at(key: torch.Tensor, i=0) -> torch.Tensor:
    """Element i of `uniform(key, shape)`: key [..., 2] -> [...]."""
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, i)
    return bits_to_uniform(x0 ^ x1)


def uniform(key: torch.Tensor, n: int) -> torch.Tensor:
    """`uniform(key, (n,))`: key [..., 2] -> [..., n]."""
    c = torch.arange(n, dtype=torch.int64, device=key.device)
    x0, x1 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, c)
    return bits_to_uniform(x0 ^ x1)
