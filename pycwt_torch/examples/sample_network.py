"""All-pairs coherence analysis of a station network.

Counterpart of ``examples/sample_network.py``: one call of
:func:`pycwt_torch.analysis.wct_matrix_analysis` computes every station's
CWT and self-smoothing once and shares them across its pairs
(``wct_matrix``), fits each station's AR(1) (``ar1_batch``), and runs the
pairs' Monte-Carlo nulls, deduplicated to distinct coefficient pairs
(``wct_significance_batch``).  The synthetic stations are AR(1)
backgrounds with a common 8-sample oscillation in half of them, so coupled
pairs must come out more significantly coherent than the rest.

Usage:  python -m pycwt_torch.examples.sample_network [--device DEV]
        (``PYCWT_TPU_NETWORK_B`` stations, default 8; ``PYCWT_TPU_MC_COUNT``
        members a null, default 300)
"""
from __future__ import annotations

import os

import numpy as np

from ..analysis import wct_matrix_analysis
from . import device_of, parser


def make_network(B=8, n0=512, seed=0):
    """``B`` AR(1) stations of ``n0`` samples; stations ``0 .. B/2-1`` share
    a sine of period 8 samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(n0)
    common = np.sin(2 * np.pi * t / 8.0)
    y = np.empty((B, n0))
    for b in range(B):
        g = rng.uniform(0.4, 0.7)
        e = rng.standard_normal(n0 + 128)
        for i in range(1, len(e)):
            e[i] += g * e[i - 1]
        y[b] = e[128:]
        if b < B // 2:
            y[b] += 2.0 * common
    return y


def band_fractions(res: dict, B: int):
    """Per pair, the fraction of the 6-12-sample band above its null:
    ``(coupled, background)`` lists, coupled when both stations carry the
    common mode."""
    band = (res["period"] >= 6) & (res["period"] <= 12)
    coupled, background = [], []
    for p, (i, j) in enumerate(res["pairs"]):
        frac = float(np.mean(res["WCT"][p][band, :] > res["sig95"][p][band][:, None]))
        (coupled if (i < B // 2 and j < B // 2) else background).append(frac)
    return coupled, background


def run(B: int | None = None, mc_count: int | None = None, device="cuda") -> dict:
    """The analysis of the ``B``-station network on ``device`` (``None``:
    ``PYCWT_TPU_NETWORK_B``, ``PYCWT_TPU_MC_COUNT``): the stations ``"y"``,
    the :func:`~pycwt_torch.analysis.wct_matrix_analysis` dict ``"res"``
    and the band fractions ``"coupled"``, ``"background"``."""
    if B is None:
        B = int(os.environ.get("PYCWT_TPU_NETWORK_B", "8"))
    if mc_count is None:
        mc_count = int(os.environ.get("PYCWT_TPU_MC_COUNT", "300"))
    y = make_network(B=B)
    res = wct_matrix_analysis(y, dt=1.0, mc_count=mc_count, cache=False,
                              device=device)
    coupled, background = band_fractions(res, B)
    return dict(B=B, y=y, res=res, coupled=coupled, background=background)


def main(device="cuda") -> dict:
    out = run(device=device)
    res, B = out["res"], out["B"]
    print(f"network: {B} stations -> {len(res['pairs'])} pairs; "
          f"coherence maps {res['WCT'].shape}, alphas "
          f"{np.round(res['alpha'], 2).tolist()}")
    coupled, background = np.mean(out["coupled"]), np.mean(out["background"])
    print(f"significant fraction in the 6-12 band: coupled pairs "
          f"{coupled:.2f} vs background pairs {background:.2f}")
    if not coupled > background:
        raise AssertionError("injected common mode should dominate the significance mask")
    print("OK")
    return out


def _cli(argv=None) -> None:
    p = parser(__doc__.splitlines()[0], outdir=False)
    args = p.parse_args(argv)
    main(device_of(p, args))


if __name__ == "__main__":
    _cli()
