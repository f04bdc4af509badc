"""Wavelet coherence of a pair of stations, as an analyst's script calls
it: ``pycwt_torch.coherence.wct(y1, y2, dt, dj=dj, significance_level=...,
wavelet=Morlet(f0))`` on host arrays, with ``sig=True, mc_count=...,
cache=False, progress=False, seed=<run seed + call index>`` when the
traffic asks for the Monte-Carlo significance and ``sig=False`` otherwise.
Call i takes pair i mod P of the pool.  A call returns host arrays, so it
ends synchronised.

The answers of a sample of the window's calls are kept: the first call and
each later one with a chance of one in ``check.kept_every``, drawn from the
seed.  Keeping every call's host arrays grew the process by some 400 MB a
window, and the page faults of that growth made the calls of ``wct_nosig``
a third slower and their times swing from run to run on the H100.  Each
kept call's WCT, phase, COI and frequencies are compared with the float64
reference of its pair (``reference/wct_f64.py``):

* ``wct_gap``:   the widest |WCT - WCT_ref| (WCT lies in [0, 1]);
* ``phase_gap``: the widest |e^{i phase} - e^{i phase_ref}| |W12_ref| over
  max |W12_ref|, so that cells where W12 vanishes, whose phase is noise,
  weigh what they are worth;
* ``grid_gap``:  the widest relative gap of the COI and the frequencies;
* ``sig_gap``:   with the significance, the widest gap of the curve over
  ``check.sig_samples`` calls drawn from the seed (rows that are NaN or 0
  in one have to be so in the other, else the gap is infinite).

The control (``control.reference``: ``"tf32"``) puts the reference computed
in TF32 in the program's place for the same calls."""
import math

import numpy as np

LIBRARIES = ("fused_cwt",)
#: call indices whose keeping is drawn from the seed; later calls are kept
#: by stride (a window holds a few thousand calls)
DRAWN = 1 << 16


def _gap(x: float) -> float:
    return x if math.isfinite(x) else math.inf


class Entry:
    def __init__(self, cell, inputs, *, seed, device, precision):
        import pycwt_torch as pt

        cfg = cell.config
        self.y1, self.y2 = inputs["y1"], inputs["y2"]
        self.pairs = self.y1.shape[0]
        self.dt, self.dj, self.f0 = float(cfg["dt"]), float(cfg["dj"]), float(cfg["f0"])
        self.level = float(cfg["significance_level"])
        self.mc_count = int(cfg["mc_count"])
        self.sig = bool(cell.traffic["sig"])
        self.seed = int(seed)
        self.device = device
        check = cell.spec.get("check", {})
        self.samples = int(check.get("sig_samples", 0))
        self.every = int(check.get("kept_every", 1))
        self.kept_at = np.random.default_rng([self.seed, 1]).integers(0, self.every, DRAWN) == 0
        self.kept_at[0] = True
        self.kw = dict(dj=self.dj, significance_level=self.level,
                       wavelet=pt.Morlet(self.f0), device=device)
        if self.sig:
            self.kw.update(sig=True, mc_count=self.mc_count, cache=False,
                           progress=False)
        else:
            self.kw.update(sig=False)
        self.kept = []
        self.shape = {"kind": "wct", "n0": self.y1.shape[1]}

    def call(self, i):
        from pycwt_torch.coherence import wct

        p = i % self.pairs
        extra = {"seed": self.seed + i} if self.sig else {}
        return wct(self.y1[p], self.y2[p], self.dt, **self.kw, **extra)

    def warm(self):
        for i in range(3):
            self.call(i)

    def keep(self, i, out):
        if self.kept_at[i] if i < DRAWN else i % self.every == 0:
            self.kept.append((i, *out))

    def units(self, i):
        return 1

    def release(self):
        pass

    def _sampled(self) -> list:
        n = len(self.kept)
        k = min(self.samples, n)
        picks = np.random.default_rng(self.seed).choice(n, size=k, replace=False)
        return sorted(int(j) for j in picks)

    def _mc(self, i: int, ar):
        from cwtbench.reference import wct_f64 as R

        p = i % self.pairs
        s0, J, _, _ = R.grid(self.y1.shape[1], self.dt, self.dj, self.f0)
        return R.mc_significance(R.ar1(self.y1[p]), R.ar1(self.y2[p]), self.dt,
                                 self.dj, s0, J, self.f0, self.mc_count,
                                 self.seed + i, self.level, ar, self.device)

    def compare(self, control=None):
        from cwtbench.reference import wct_f64 as R

        if not self.kept:
            return dict.fromkeys(("wct_gap", "phase_gap", "grid_gap")
                                 + (("sig_gap",) if self.sig else ()), math.inf)
        ref = R.Arith("f64")
        refs = {p: R.wct(self.y1[p], self.y2[p], self.dt, self.dj, self.f0, ref,
                         self.device)
                for p in sorted({i % self.pairs for i, *_ in self.kept})}
        kept = self.kept
        if control is not None:
            low = R.Arith(control)
            lows = {p: R.wct(self.y1[p], self.y2[p], self.dt, self.dj, self.f0,
                             low, self.device) for p in refs}
            kept = [(i, *lows[i % self.pairs][:4], sig) for i, _, _, _, _, sig in kept]
        gaps = {"wct_gap": 0.0, "phase_gap": 0.0, "grid_gap": 0.0}
        for i, w, ph, coi, freq, _ in kept:
            rw, rph, rcoi, rfreq, mag = refs[i % self.pairs]
            if w.shape != rw.shape or ph.shape != rph.shape or coi.shape != rcoi.shape \
                    or freq.shape != rfreq.shape:
                return {k: math.inf for k in gaps} | ({"sig_gap": math.inf} if self.sig else {})
            turn = np.abs(np.exp(1j * ph) - np.exp(1j * rph)) * mag / mag.max()
            grid = np.max(np.abs(np.concatenate([coi / rcoi - 1, freq / rfreq - 1])))
            for k, v in (("wct_gap", np.max(np.abs(w - rw))),
                         ("phase_gap", np.max(turn)), ("grid_gap", grid)):
                gaps[k] = max(gaps[k], _gap(float(v)))
        if not self.sig:
            return gaps
        gap = 0.0
        for j in self._sampled():
            i, sig = kept[j][0], np.asarray(kept[j][5], np.float64)
            want = self._mc(i, ref)
            got = self._mc(i, R.Arith(control)) if control is not None else sig
            if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)) \
                    or not np.array_equal(got == 0, want == 0):
                gap = math.inf
                continue
            m = np.isfinite(want)
            gap = max(gap, _gap(float(np.max(np.abs(got[m] - want[m]), initial=0.0))))
        gaps["sig_gap"] = gap
        return gaps
