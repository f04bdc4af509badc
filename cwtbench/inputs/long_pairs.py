"""Pairs of long records that share a red component: for each pair an
AR(1) process c with its own lag-1 coefficient g ~ U(g_lo, g_hi), run
``burn_in`` samples before it is kept, and two independent unit normal
series e1, e2: y1 = c + e1, y2 = ``share`` c + e2.  The normals are drawn
on the device from the seed with one ``torch.Generator``, in three calls;
the recursion runs on the host in float64 by ``scipy.signal.lfilter``,
whole records at once, since the program takes host arrays.

Parameters: ``pairs``, ``n0``, ``g`` ([g_lo, g_hi]), ``burn_in``,
``share``.  Returns float64 arrays ``y1``, ``y2`` (pairs, n0)."""
import numpy as np
import torch
from scipy.signal import lfilter


def make(params: dict, seed: int, device: str) -> dict:
    P, n0, burn = params["pairs"], params["n0"], params["burn_in"]
    g_lo, g_hi = params["g"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=gen, device=device, dtype=torch.float64)
    g = (g_lo + (g_hi - g_lo) * torch.rand(P, **kw)).cpu().numpy()
    z = torch.randn((P, n0 + burn), **kw).cpu().numpy()
    e = torch.randn((P, 2, n0), **kw).cpu().numpy()
    c = np.stack([lfilter([1.0], [1.0, -gp], zp)[burn:] for gp, zp in zip(g, z)])
    return {"y1": c + e[:, 0], "y2": params["share"] * c + e[:, 1]}
