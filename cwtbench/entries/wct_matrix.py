"""All-pairs wavelet coherence of a network of stations, as an analyst's
script calls it: ``pycwt_torch.coherence.wct_matrix(y, dt, dj=dj,
wavelet=Morlet(f0))`` on the network's host array (stations, n0), with
the configuration's values and the program's own defaults for everything
else: every i < j pair, its own blocking of the pairs, both maps fetched
to host numpy, its card, its ``high`` tier.  A call returns host arrays,
so it ends synchronised.  Call i takes network i mod N.

A call's two float32 maps take 2 P S n0 4 bytes of the program's
page-locked host blocks (447 MB for 32 stations of 1024 samples), so three
calls' answers are kept: the first, one drawn from the seed among calls
1-15, and the last.  The warm-up holds four calls' answers at once, so
that the window finds the page-locked blocks it needs already made.  Each
kept call is compared in full, every pair, with the float64 reference of
its network (``reference/wct_matrix_f64.py``), block by block on the run's
device:

* ``wct_gap``:   the widest |WCT - WCT_ref| (WCT lies in [0, 1]);
* ``phase_gap``: the widest |e^{i phase} - e^{i phase_ref}| |W12_ref| over
  the pair's max |W12_ref|, so that cells where W12 vanishes, whose phase
  is noise, weigh what they are worth (as ``entries/wct.py``);
* ``grid_gap``:  the widest relative gap of the COI and the frequencies;
* ``pairs_gap``: how many rows of the returned pairs differ from the
  i < j list in row-major order.

A map whose shape is not (P, S, n0) or whose dtype is not float32, or a
COI, frequencies or pair list of another shape, reads infinite everywhere.
The control (``control.reference``: ``"tf32"``) puts the reference computed
in TF32 in the program's place for the same calls."""
import math

import numpy as np
import torch

LIBRARIES = ("fused_cwt",)
#: calls among which the one drawn from the seed is kept (the first is
#: kept anyway)
DRAWN = 16
#: the answers the warm-up holds at once: the kept calls, the last call
#: and the one in progress
WARM = 4
#: Morlet's scale-decorrelation length (Torrence & Compo 1998, Table 2),
#: which sets the boxcar's taps, round(2 deltaj0 / dj)
DELTAJ0 = 0.6


def _gap(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def map_gaps(ref, got, device) -> tuple:
    """(wct_gap, phase_gap) over every pair of the reference network
    ``ref``, block by block on ``device``; ``got(lo, hi)`` gives the
    (WCT, phase) of the pairs lo:hi being compared."""
    w_gap = ph_gap = 0.0
    for lo, hi, rw, rph, mag in ref.blocks():
        w, ph = (torch.as_tensor(m).to(device=device, dtype=torch.float64)
                 for m in got(lo, hi))
        weight = mag / mag.amax(dim=(1, 2), keepdim=True)
        turn = 2 * torch.sin(0.5 * (ph - rph)).abs() * weight
        w_gap = max(w_gap, _gap(float((w - rw).abs().max())))
        ph_gap = max(ph_gap, _gap(float(turn.max())))
    return w_gap, ph_gap


class Entry:
    def __init__(self, cell, inputs, *, seed, device, precision):
        import pycwt_torch as pt
        from cwtbench.reference import wct_matrix_f64 as R
        from cwtbench.reference.wct_f64 import grid
        from pycwt_torch.config import DEFAULT, CWTConfig

        cfg = cell.config
        self.y = inputs["y"]
        self.networks, B, self.n0 = self.y.shape
        self.dt, self.dj, self.f0 = float(cfg["dt"]), float(cfg["dj"]), float(cfg["f0"])
        self.device = device
        self.kw = dict(dj=self.dj, wavelet=pt.Morlet(self.f0))
        if precision != DEFAULT.precision:
            self.kw["config"] = CWTConfig(precision=precision)
        if device != "cuda":
            self.kw["device"] = device
        self.pairs = R.all_pairs(B)
        S = len(grid(self.n0, self.dt, self.dj, self.f0)[2])
        self.shape = {"kind": "wct_matrix", "B": B, "P": len(self.pairs), "S": S,
                      "n0": self.n0, "nfft": 1 << (self.n0 - 1).bit_length(),
                      "taps": int(np.round(2 * DELTAJ0 / self.dj))}
        self.held = {0, int(np.random.default_rng(seed).integers(1, DRAWN))}
        self.kept = {}
        self.last = None

    def call(self, i):
        from pycwt_torch.coherence import wct_matrix

        return wct_matrix(self.y[i % self.networks], self.dt, **self.kw)

    def warm(self):
        outs = [self.call(i) for i in range(WARM)]
        del outs

    def keep(self, i, out):
        if self.last is not None and self.last not in self.held:
            self.kept.pop(self.last, None)
        self.kept[i] = out
        self.last = i

    def units(self, i):
        return 1

    def release(self):
        pass

    def _well_formed(self, out) -> bool:
        WCT, aWCT, coi, freqs, pairs = out
        P, S, n0 = self.shape["P"], self.shape["S"], self.n0
        return all(np.shape(m) == (P, S, n0) and np.asarray(m).dtype == np.float32
                   for m in (WCT, aWCT)) and np.shape(coi) == (n0,) \
            and np.shape(freqs) == (S,) and np.shape(pairs) == self.pairs.shape

    def compare(self, control=None):
        from cwtbench.reference import wct_matrix_f64 as R

        names = ("wct_gap", "phase_gap", "grid_gap", "pairs_gap")
        if not self.kept:
            return dict.fromkeys(names, math.inf)
        gaps = dict.fromkeys(names, 0.0)
        refs, lows = {}, {}
        for i, out in sorted(self.kept.items()):
            k = i % self.networks
            if k not in refs:
                refs[k] = R.Network(self.y[k], self.dt, self.dj, self.f0,
                                    R.Arith("f64"), self.device)
                if control is not None:
                    lows[k] = R.Network(self.y[k], self.dt, self.dj, self.f0,
                                        R.Arith(control), self.device)
            if control is not None:
                low = lows[k]
                got_coi, got_freqs, got_pairs = low.coi, low.freqs, low.pairs

                def got(lo, hi):
                    return low.maps(low.pairs[lo:hi, 0], low.pairs[lo:hi, 1])[:2]
            elif not self._well_formed(out):
                return dict.fromkeys(names, math.inf)
            else:
                WCT, aWCT, got_coi, got_freqs, got_pairs = out

                def got(lo, hi):
                    return WCT[lo:hi], aWCT[lo:hi]
            ref = refs[k]
            grid = max(float(np.max(np.abs(np.asarray(a, np.float64) / b - 1)))
                       for a, b in ((got_coi, ref.coi), (got_freqs, ref.freqs)))
            off = np.any(np.asarray(got_pairs) != self.pairs, axis=1).sum()
            found = (*map_gaps(ref, got, self.device), _gap(grid), float(off))
            for name, v in zip(names, found):
                gaps[name] = max(gaps[name], v)
        return gaps
