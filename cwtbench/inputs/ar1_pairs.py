"""Pairs of stations: each series an AR(1) process with its own lag-1
coefficient g ~ U(g_lo, g_hi), run ``burn_in`` samples before it is kept,
plus a shared oscillation of ``amplitude`` and ``period`` samples, the
second series' copy shifted by a phase drawn from U(0, 2 pi).  The random
draws are made on the device from the seed with one ``torch.Generator``,
in three calls; the recursion runs on the host in float64, since the
program takes host arrays.

Parameters: ``pairs``, ``n0``, ``g`` ([g_lo, g_hi]), ``burn_in``,
``period``, ``amplitude``.  Returns float64 arrays ``y1``, ``y2`` (pairs,
n0)."""
import numpy as np
import torch


def make(params: dict, seed: int, device: str) -> dict:
    P, n0, burn = params["pairs"], params["n0"], params["burn_in"]
    g_lo, g_hi = params["g"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=gen, device=device, dtype=torch.float64)
    g = (g_lo + (g_hi - g_lo) * torch.rand((P, 2), **kw)).cpu().numpy()
    z = torch.randn((P, 2, n0 + burn), **kw).cpu().numpy()
    lag = (2 * np.pi * torch.rand(P, **kw)).cpu().numpy()
    y = np.empty_like(z)
    y[..., 0] = z[..., 0]
    for t in range(1, z.shape[-1]):
        y[..., t] = g * y[..., t - 1] + z[..., t]
    y = y[..., burn:]
    phase = 2 * np.pi * np.arange(n0) / params["period"]
    amp = params["amplitude"]
    y1 = y[:, 0] + amp * np.sin(phase)[None, :]
    y2 = y[:, 1] + amp * np.sin(phase[None, :] + lag[:, None])
    return {"y1": y1, "y2": y2}
