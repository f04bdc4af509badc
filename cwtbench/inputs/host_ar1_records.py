"""Records as a user hands them to the public API: host float64 numpy,
C-contiguous, each a stationary AR(1) process of unit variance,

    y[0] = z[0],   y[t] = g y[t-1] + sqrt(1 - g^2) z[t],

with z standard normal, drawn on the device from the seed with one
``torch.Generator`` in one call.  The recursion runs on the host in
float64, in blocks of L = ceil(sqrt(n0)) samples: each block's own
recursion, vectorized over blocks, then the carries from block to block,
each block's first sample taking g^(t+1) of the last one before it.

Parameters: ``records`` (how many distinct records the calls cycle
through), ``n0`` (samples a record) and ``g`` (the lag-1 coefficient).
Returns ``x``, float64 (records, n0)."""
import math

import numpy as np
import torch


def make(params: dict, seed: int, device: str) -> dict:
    R, n0, g = params["records"], params["n0"], float(params["g"])
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((R, n0), generator=gen, device=device,
                    dtype=torch.float64).cpu().numpy()
    z[:, 1:] *= math.sqrt(1.0 - g * g)
    L = math.isqrt(n0 - 1) + 1
    C = -(-n0 // L)
    e = np.zeros((R, C * L))
    e[:, :n0] = z
    e = e.reshape(R, C, L)
    for t in range(1, L):                  # each block from zero
        e[:, :, t] += g * e[:, :, t - 1]
    carry = np.zeros((R, C))              # y just before each block
    for c in range(1, C):
        carry[:, c] = e[:, c - 1, -1] + g ** L * carry[:, c - 1]
    e += carry[:, :, None] * g ** np.arange(1, L + 1)
    return {"x": np.ascontiguousarray(e.reshape(R, C * L)[:, :n0])}
