"""Networks of stations: each station an AR(1) process with its own lag-1
coefficient g ~ U(g_lo, g_hi), y[t] = g y[t-1] + z[t] with z standard
normal, run ``burn_in`` samples before it is kept; the first half of each
network's stations also share an oscillation of ``amplitude`` and
``period`` samples, each station's copy shifted by a phase drawn from
U(0, 2 pi), so that part of the coherence maps is coherent and has a
phase.  The random draws are made on the device from the seed with one
``torch.Generator``, in three calls; the recursion runs on the host in
float64, vectorized over the stations, since the program takes host
arrays.

Parameters: ``networks`` (how many distinct networks the calls cycle
through), ``stations``, ``n0``, ``g`` ([g_lo, g_hi]), ``burn_in``,
``period``, ``amplitude``.  Returns ``y``, float64 (networks, stations,
n0), C-contiguous."""
import numpy as np
import torch


def make(params: dict, seed: int, device: str) -> dict:
    N, B, n0 = params["networks"], params["stations"], params["n0"]
    burn = params["burn_in"]
    g_lo, g_hi = params["g"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kw = dict(generator=gen, device=device, dtype=torch.float64)
    g = (g_lo + (g_hi - g_lo) * torch.rand((N, B), **kw)).cpu().numpy()
    z = torch.randn((N, B, n0 + burn), **kw).cpu().numpy()
    lag = (2 * np.pi * torch.rand((N, B // 2, 1), **kw)).cpu().numpy()
    y = np.empty_like(z)
    y[..., 0] = z[..., 0]
    for t in range(1, z.shape[-1]):
        y[..., t] = g * y[..., t - 1] + z[..., t]
    y = y[..., burn:]
    phase = 2 * np.pi * np.arange(n0) / params["period"]
    y[:, : B // 2] += params["amplitude"] * np.sin(phase + lag)
    return {"y": np.ascontiguousarray(y)}
