"""Complete Torrence & Compo Figure-1 analysis on a bundled dataset.

Counterpart of ``examples/sample_cwt.py``: CWT with Morlet(6), pointwise
significance, global and 2-8 year scale-averaged spectra and the
reconstruction through :func:`pycwt_torch.analysis.cwt_analysis`, and the
same 4-panel figure with the same labels where matplotlib is installed.

Usage:  python -m pycwt_torch.examples.sample_cwt
        [nino3|mauna|monsoon|sunspots|soi|--all] [--outdir DIR] [--device DEV]
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

from .. import Morlet, significance
from ..analysis import cwt_analysis
from ..sample import load
from . import device_of, parser, pyplot

DATASETS = ("nino3", "mauna", "monsoon", "sunspots", "soi")


def run(name: str = "nino3", device="cuda") -> dict:
    """The analysis of dataset ``name`` on ``device``: the dataset
    (``"dataset"``), the :class:`~pycwt_torch.analysis.CWTAnalysis`
    (``"res"``), the reconstruction's rms error (``"rms_err"``) and panel
    c's extras: the red-noise spectrum (``"fft_theor"``), the signal's
    one-sided Fourier power and its frequencies (``"fft_power"``,
    ``"fftfreqs"``)."""
    ds = load(name)
    mother = Morlet(6)
    res = cwt_analysis(ds.values, ds.dt, t0=ds.t0, mother=mother,
                       avg_band=(2, 8), device=device)
    nfft = 1 << (len(res.signal) - 1).bit_length()
    fft = np.fft.fft(res.signal, nfft)[1:nfft // 2] / nfft ** 0.5
    _, fft_theor = significance(1.0, ds.dt, res.scales, 0, alpha=res.alpha,
                                wavelet=mother)
    return dict(dataset=ds, mother=mother, res=res,
                rms_err=float(np.sqrt(np.mean((res.iwave / res.std - res.signal) ** 2))),
                fft_theor=fft_theor, fft_power=np.abs(fft) ** 2,
                fftfreqs=np.fft.fftfreq(nfft, ds.dt)[1:nfft // 2])


def main(name: str = "nino3", outdir: str | None = None, device="cuda") -> dict:
    out = run(name, device)
    ds, res, mother = out["dataset"], out["res"], out["mother"]
    print(f"{ds.label}: N={len(ds.values)}, {len(res.scales)} scales, "
          f"alpha={res.alpha:.3f}")
    print(f"reconstruction rms err: {out['rms_err']:.4f}")

    plt = pyplot()
    if plt is None:
        print("matplotlib unavailable — skipping figure")
        return out

    lab = ds.labels(usetex=False)
    plt.rcParams.update({"font.size": 13.0, "axes.grid": True})
    fig = plt.figure(figsize=(11, 8))
    ax = plt.axes([0.1, 0.75, 0.65, 0.2])
    ax.plot(res.t, res.iwave / res.std, "-", lw=1, color="0.5")
    ax.plot(res.t, res.signal, "k", lw=1.5)
    ax.set_title(f"a) {lab['title']}")
    ax.set_ylabel(f"{lab['label']} [{lab['units']}]" if lab["units"]
                  else lab["label"])

    bx = plt.axes([0.1, 0.37, 0.65, 0.28], sharex=ax)
    levels = [0.0625, 0.125, 0.25, 0.5, 1, 2, 4, 8, 16]
    bx.contourf(res.t, np.log2(res.period), np.log2(res.power),
                np.log2(levels), extend="both", cmap="viridis")
    bx.contour(res.t, np.log2(res.period), res.sig95, [-99, 1], colors="k",
               linewidths=2)
    bx.fill(np.concatenate([res.t, res.t[-1:] + ds.dt, res.t[-1:] + ds.dt,
                            res.t[:1] - ds.dt, res.t[:1] - ds.dt]),
            np.concatenate([np.log2(res.coi), [1e-9], [np.log2(res.period[-1])],
                            [np.log2(res.period[-1])], [1e-9]]),
            "k", alpha=0.3, hatch="x")
    bx.set_title(f"b) {lab['label']} Wavelet Power Spectrum ({mother.name})")
    bx.set_ylabel("Period (years)")
    yticks = 2 ** np.arange(np.ceil(np.log2(res.period.min())),
                            np.ceil(np.log2(res.period.max())))
    bx.set_yticks(np.log2(yticks))
    bx.set_yticklabels(yticks)

    var = res.std ** 2
    cx = plt.axes([0.77, 0.37, 0.2, 0.28], sharey=bx)
    cx.plot(res.global_signif, np.log2(res.period), "k--")
    cx.plot(var * out["fft_theor"], np.log2(res.period), "--", color="#cccccc")
    cx.plot(var * out["fft_power"], np.log2(1.0 / out["fftfreqs"]), "-",
            color="#cccccc", lw=1.0)
    cx.plot(res.global_power, np.log2(res.period), "k-", lw=1.5)
    cx.set_title("c) Global Wavelet Spectrum")
    cx.set_xlabel(f"Power [{lab['units2']}]" if lab["units2"] else "Power")
    cx.set_xlim([0, res.global_power.max() + var])
    cx.set_ylim(np.log2([res.period.min(), res.period.max()]))
    cx.set_yticks(np.log2(yticks))
    cx.set_yticklabels(yticks)
    plt.setp(cx.get_yticklabels(), visible=False)

    dx = plt.axes([0.1, 0.07, 0.65, 0.2], sharex=ax)
    dx.axhline(res.scale_avg_signif, color="k", linestyle="--", lw=1)
    dx.plot(res.t, res.scale_avg, "k-", lw=1.5)
    dx.set_title(f"d) {res.avg_band[0]}–{res.avg_band[1]} year "
                 "scale-averaged power")
    dx.set_xlabel("Time (year)")
    dx.set_ylabel(f"Average variance [{lab['units']}]" if lab["units"]
                  else "Average variance")
    ax.set_xlim([res.t.min(), res.t.max()])

    path = os.path.join(outdir or tempfile.gettempdir(), f"sample_{name}.png")
    fig.savefig(path, dpi=96)
    plt.close(fig)
    print(f"figure saved to {path}")
    return out


def _cli(argv=None) -> None:
    p = parser(__doc__.splitlines()[0])
    p.add_argument("name", nargs="?", default="nino3", choices=DATASETS)
    p.add_argument("--all", action="store_true", help="run all five datasets")
    args = p.parse_args(argv)
    device = device_of(p, args)
    for name in (DATASETS if args.all else (args.name,)):
        main(name, args.outdir, device)


if __name__ == "__main__":
    _cli()
