"""A line set as a renderer receives it, worked out from the `.binlines`
file the program loads: read the file, pad every line to the longest
(rounded up to 8 points) by repeating its last point and value, min-max
normalise the attribute over the valid points, and cut the lines into
capsule segments (a segment joins two valid points; a chain's first segment
draws its start cap)."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

# A pixel is wrong where a channel differs from the reference's by more
# than this times (1 + |reference|).
PIXEL_TOLERANCE = 1e-4


def strata_rows(rng, lo: int, hi: int, n: int):
    """n rows of [lo, hi], one drawn from each of n equal strata (so that
    every part of the band is looked at)."""
    edges = np.linspace(lo, hi + 1, min(n, hi - lo + 1) + 1)
    return [int(rng.integers(int(a), max(int(b), int(a) + 1))) for a, b in zip(edges, edges[1:])]


@dataclasses.dataclass
class Lines:
    positions: np.ndarray  # [L, P, 3] float32
    mask: np.ndarray  # [L, P] bool
    attr: np.ndarray  # [L, P] float32 in [0, 1]


def read_binlines(path: str) -> Lines:
    """Version 1 or 2 `.binlines`, the first attribute; positions as stored
    (the files the harness writes say they are normalised already)."""
    with open(path, "rb") as f:
        data = f.read()
    version, n_lines, n_attr = struct.unpack_from("<III", data, 0)
    if version not in (1, 2) or n_attr < 1:
        raise ValueError(f"{path}: .binlines version {version} with {n_attr} attributes")
    off = 12
    pos, att = [], []
    for _ in range(n_lines):
        (n,) = struct.unpack_from("<I", data, off)
        off += 4
        pos.append(np.frombuffer(data, "<f4", 3 * n, off).reshape(n, 3).astype(np.float32))
        off += 12 * n
        att.append(np.frombuffer(data, "<f4", n, off).astype(np.float32))
        off += 4 * n * n_attr
    P = max(max(p.shape[0] for p in pos), 2)
    P = max(-(-P // 8) * 8, 8)
    positions = np.zeros((n_lines, P, 3), np.float32)
    attr = np.zeros((n_lines, P), np.float32)
    mask = np.zeros((n_lines, P), bool)
    for i, (p, a) in enumerate(zip(pos, att)):
        n = p.shape[0]
        positions[i, :n], positions[i, n:] = p, p[n - 1]
        attr[i, :n], attr[i, n:] = a, a[n - 1]
        mask[i, :n] = True
    big = np.float32(3.0e38)
    lo = np.where(mask, attr, big).min()
    hi = np.where(mask, attr, -big).max()
    attr = np.clip((attr - lo) / np.maximum(hi - lo, np.float32(1e-7)), 0.0, 1.0).astype(np.float32)
    return Lines(positions, mask, attr)


@dataclasses.dataclass
class Capsules:
    a: torch.Tensor  # [3, S]
    ba: torch.Tensor  # [3, S]
    attr0: torch.Tensor  # [S]
    dattr: torch.Tensor  # [S]
    mask: torch.Tensor  # [S] bool
    cap_a: torch.Tensor  # [S] float 0/1
    radius: float


def capsules(lines: Lines, radius: float, device, dtype=torch.float32) -> Capsules:
    """Segment j of line l is capsule l * (P - 1) + j."""
    pos = torch.tensor(lines.positions, device=device).to(dtype)
    L, P = pos.shape[0], pos.shape[1]
    cf = pos.reshape(L * P, 3).T.reshape(3, L, P)
    a = cf[:, :, :-1].reshape(3, -1)
    b = cf[:, :, 1:].reshape(3, -1)
    m = torch.tensor(lines.mask, device=device)
    seg = m[:, :-1] & m[:, 1:]
    at = torch.tensor(lines.attr, device=device).to(dtype)
    a0, a1 = at[:, :-1].reshape(-1), at[:, 1:].reshape(-1)
    prev = torch.cat([torch.zeros((L, 1), dtype=torch.bool, device=device), seg[:, :-1]], dim=1)
    return Capsules(a=a, ba=b - a, attr0=a0, dattr=a1 - a0, mask=seg.reshape(-1),
                    cap_a=(~prev).reshape(-1).to(dtype), radius=float(radius))
