"""Cross-wavelet and wavelet-coherence analysis of the Arctic Oscillation
vs Baltic sea-ice pair.

Counterpart of ``examples/sample_xwt.py``: boxpdf preprocessing, XWT at the
86.46 % Grinsted convention, WCT with its Monte-Carlo significance (300
surrogate pairs unless ``PYCWT_TPU_MC_COUNT`` says otherwise, cached on
disk at 300), and the phase arrows, drawn where matplotlib is installed.

Usage:  python -m pycwt_torch.examples.sample_xwt [--outdir DIR] [--device DEV]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from ..analysis import phase_arrows, wct_analysis, xwt_analysis
from ..sample import load
from . import device_of, parser, pyplot


def run(mc_count: int | None = None, device="cuda") -> dict:
    """The analysis on ``device``: the time axis ``"t"``, the
    :func:`~pycwt_torch.analysis.xwt_analysis` and
    :func:`~pycwt_torch.analysis.wct_analysis` dicts (``"xwt"``, ``"wct"``)
    and the phase arrows (``"u"``, ``"v"``).  ``mc_count=None`` reads
    ``PYCWT_TPU_MC_COUNT`` (default 300): tests run the script with a cheap
    ensemble, whose statistics mean nothing below ~100."""
    if mc_count is None:
        mc_count = int(os.environ.get("PYCWT_TPU_MC_COUNT", "300"))
    jao = load("jao")
    jbaltic = load("jbaltic")
    n = min(jao.values.size, jbaltic.values.size)
    y1, y2 = jao.values[:n], jbaltic.values[:n]
    dt = jao.dt
    x = xwt_analysis(y1, y2, dt, boxpdf_transform=True, device=device)
    w = wct_analysis(y1, y2, dt, sig=True, mc_count=mc_count, progress=True,
                     cache=mc_count == 300, device=device)
    u, v = phase_arrows(w["phase"])
    return dict(t=jao.t0 + np.arange(n) * dt, dt=dt, xwt=x, wct=w, u=u, v=v)


def main(outdir: str | None = None, device="cuda") -> dict:
    out = run(device=device)
    x, w, t, dt = out["xwt"], out["wct"], out["t"], out["dt"]
    print(f"XWT: {x['W12'].shape}, max cross power {x['cross_power'].max():.3f}")
    print(f"WCT: mean coherence {np.nanmean(w['WCT']):.3f}")

    plt = pyplot()
    if plt is None:
        return out
    n = t.size
    u, v = out["u"], out["v"]

    def coi_fill(axis, coi, period):
        axis.fill(
            np.concatenate([t, t[-1:] + dt, t[-1:] + dt, t[:1] - dt,
                            t[:1] - dt]),
            np.concatenate([np.log2(coi), [np.log2(1e-9)],
                            np.log2(period[-1:]), np.log2(period[-1:]),
                            [np.log2(1e-9)]]),
            "k", alpha=0.3, hatch="x")

    fig, (a, b) = plt.subplots(2, 1, figsize=(10, 8), sharex=True)
    a.contourf(t, np.log2(x["period"]), np.log2(x["cross_power"]), 12,
               cmap="viridis")
    a.contour(t, np.log2(x["period"]), x["cross_sig"], [-99, 1], colors="k",
              linewidths=2)
    coi_fill(a, x["coi"], x["period"])
    a.set_title("Cross-Wavelet")
    a.set_ylabel("log2(Period)")
    a.set_ylim(np.log2([x["period"].min(), x["period"].max()]))
    a.invert_yaxis()
    b.contourf(t, np.log2(w["period"]), w["WCT"], 12, cmap="viridis")
    sig = w["sig95"]
    if np.ndim(sig) == 1 and len(sig) == len(w["period"]):
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = w["WCT"] / sig[:, None]
        b.contour(t, np.log2(w["period"]), ratio, [-99, 1], colors="k",
                  linewidths=2)
    coi_fill(b, w["coi"], w["period"])
    step = max(1, n // 40)
    b.quiver(t[::step], np.log2(w["period"][::4]),
             u[::4, ::step], v[::4, ::step], units="width", angles="uv",
             pivot="mid", scale=40)
    b.set_title("Cross-Correlation")
    b.set_ylabel("log2(Period)")
    b.set_xlabel("Time (year)")
    b.invert_yaxis()
    path = os.path.join(outdir or tempfile.gettempdir(), "sample_xwt.png")
    fig.savefig(path, dpi=96)
    plt.close(fig)
    print(f"figure saved to {path}")
    return out


def _cli(argv=None) -> None:
    p = parser(__doc__.splitlines()[0])
    args = p.parse_args(argv)
    main(args.outdir, device_of(p, args))


if __name__ == "__main__":
    _cli()
