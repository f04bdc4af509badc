"""JAX's counter-based random streams, frozen for the reference.

The Monte-Carlo null of ``wct(sig=True)`` draws its AR(1) surrogates from
``jax.random``'s threefry2x32 streams: member ``i`` of the pair's first
(second) series takes the key ``fold_in(split(PRNGKey(seed))[0 or 1], i)``
and its normals are ``jax.random.normal(key, (n + tau,), float64)``.  The
reference draws the same members, so this is a copy of that key schedule
(Salmon et al. 2011, "Parallel random numbers: as easy as 1, 2, 3"; JAX's
``jax/_src/prng.py``), written from the published algorithm in plain
``torch`` int64 arithmetic.  It is frozen here: a change to the program's
own generator must not move the reference with it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: nextafter(-1, +inf): the low end of jax.random.normal's uniform draw
NORMAL_LO = float(np.nextafter(-1.0, np.inf))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds: key words ``(k0, k1)`` encrypt the counter
    words ``(x0, x1)``; int64 tensors holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def prng_key(seed: int, device=None):
    """``PRNGKey(seed)``: the high and low 32-bit words of the seed."""
    seed = int(seed)
    return (torch.tensor((seed >> 32) & MASK32, dtype=torch.int64, device=device),
            torch.tensor(seed & MASK32, dtype=torch.int64, device=device))


def fold_in(key, data):
    """``fold_in(key, data)`` for every element of the int64 tensor ``data``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key[0].device)
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data & MASK32)


def split2(key):
    """``split(key)`` into two keys: key j is threefry2x32(key, (0, j))."""
    k0, k1 = fold_in(key, torch.arange(2, device=key[0].device))
    return (k0[0], k1[0]), (k0[1], k1[1])


def normal_f64(key, length: int) -> torch.Tensor:
    """``normal(k, (length,), float64)`` for each key of a batch of keys:
    the top 52 bits of threefry2x32(k, (0, i)) as u in [0, 1), mapped onto
    [nextafter(-1, inf), 1), then sqrt(2)·erfinv(u)."""
    k0, k1 = key[0][..., None], key[1][..., None]
    count = torch.arange(length, dtype=torch.int64, device=k0.device)
    hi, lo = threefry2x32(k0, k1, torch.zeros_like(count), count)
    mantissa = ((hi << 20) | (lo >> 12)) & ((1 << 52) - 1)
    u = mantissa.to(torch.float64) * 2.0 ** -52
    u = torch.clamp_min(u * (1.0 - NORMAL_LO) + NORMAL_LO, NORMAL_LO)
    return math.sqrt(2.0) * torch.erfinv(u)


def burn_in(g: float) -> int:
    """tau = ceil(-2/log|g|), twice the decorrelation time (0 for g = 0)."""
    return 0 if g == 0.0 else int(math.ceil(-2.0 / math.log(abs(g))))
