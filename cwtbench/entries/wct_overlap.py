"""Wavelet coherence of a pair of long records by overlap-save, as an
analyst's script calls it:
``pycwt_torch.ops.overlap.wct_overlap_planar(y1, y2, scales, dt,
mother=Morlet(f0), dj=dj)`` on the pair's host float64 arrays, the scales
s0 2^(j dj) as a host float64 array, and the program's own defaults for
the chunk, eps, tier, normalisation and device (the card).  Call i takes
pair i mod P.  Each call ends with a device synchronize, since the
analyst's next line reads the maps, so a call's time is the wait for them;
the two float32 (S, N) maps stay on the card.

A call's two maps take 2 S N 4 bytes (8.6 GB at 2^24 samples of 64
scales), so three calls' answers are kept: the first, one drawn from the
seed among calls 1-7, and the last.  The warm-up holds four calls' answers
at once, so that the window finds the device blocks it needs already
made.  Each kept answer is compared in full, every scale and sample, with
the float64 reference of its pair (``reference/wct_overlap_f64.py``),
chunk by chunk on the run's device, with the framing the configuration
states (its ``chunk`` and ``eps``):

* ``wct_gap``:   the widest |WCT - WCT_ref| (WCT lies in [0, 1]);
* ``phase_gap``: the widest |e^{i phase} - e^{i phase_ref}| |W12_ref| over
  max |W12_ref|, so that cells where W12 vanishes, whose phase is noise,
  weigh what they are worth (as ``entries/wct_matrix.py``).

An answer that is not two (S, N) float32 maps reads infinite everywhere.
The control (``control.precision``: ``"fast"``) runs the program at its
bf16-T tier; ``compare(control="tf32")`` puts the reference computed in
TF32 in the program's place for the same calls."""
import math

import numpy as np
import torch

LIBRARIES = ("fused_cwt",)
#: calls among which the one drawn from the seed is kept (the first is
#: kept anyway)
DRAWN = 8
#: the answers the warm-up holds at once: the kept calls, the last call
#: and the one in progress
WARM = 4
#: ``wct_overlap_planar``'s default chunk: a configuration's other chunk
#: is passed to the call
SURFACE_CHUNK = 1 << 18
#: Morlet's scale-decorrelation length (Torrence & Compo 1998, Table 2),
#: which sets the boxcar's taps, round(2 deltaj0 / dj)
DELTAJ0 = 0.6


def _gap(x: float) -> float:
    return x if math.isfinite(x) else math.inf


class Entry:
    def __init__(self, cell, inputs, *, seed, device, precision):
        import pycwt_torch as pt
        from cwtbench import harness
        from cwtbench.reference import wct_overlap_f64 as R

        cfg = cell.config
        self.y1, self.y2 = inputs["y1"], inputs["y2"]
        self.pairs, self.N = self.y1.shape
        self.dt, self.dj, self.f0 = float(cfg["dt"]), float(cfg["dj"]), float(cfg["f0"])
        self.chunk, self.eps = int(cfg["chunk"]), float(cfg["eps"])
        self.scales = R.scales(int(cfg["J"]) + 1, self.dt, self.dj, float(cfg["s0_dt"]))
        self.device = device
        self.sync = harness.device_sync(device)
        self.kw = dict(mother=pt.Morlet(self.f0), dj=self.dj)
        if self.chunk != SURFACE_CHUNK:
            self.kw["chunk"] = self.chunk
        if precision != cell.precision:
            self.kw["precision"] = precision
        if device != "cuda":
            self.kw["device"] = device
        f = R.framing(self.N, float(self.scales.max()), self.dt, self.chunk, self.eps)
        self.shape = {"kind": "wct_overlap", "B": 2, "P": 1, "N": self.N,
                      "S": len(self.scales), "chunk": self.chunk,
                      "nfft_c": f["nfft_c"], "H": f["H"],
                      "taps": int(np.round(2 * DELTAJ0 / self.dj))}
        self.held = {0, int(np.random.default_rng(seed).integers(1, DRAWN))}
        self.kept = {}
        self.last = None

    def call(self, i):
        from pycwt_torch.ops.overlap import wct_overlap_planar

        k = i % self.pairs
        out = wct_overlap_planar(self.y1[k], self.y2[k], self.scales, self.dt, **self.kw)
        self.sync()
        return out

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
        want = (self.shape["S"], self.N)
        return (isinstance(out, tuple) and len(out) == 2
                and all(isinstance(m, torch.Tensor) and tuple(m.shape) == want
                        and m.dtype == torch.float32 for m in out))

    def _reference(self, k: int, mode: str = "f64"):
        from cwtbench.reference import wct_overlap_f64 as R

        return R.chunks(self.y1[k], self.y2[k], self.scales, self.dt, self.dj,
                        self.f0, chunk=self.chunk, eps=self.eps,
                        device=self.device, mode=mode)

    def compare(self, control=None):
        names = ("wct_gap", "phase_gap")
        if not self.kept or not all(map(self._well_formed, self.kept.values())):
            return dict.fromkeys(names, math.inf)
        w_gap = ph_gap = 0.0
        for k in sorted({i % self.pairs for i in self.kept}):
            maps = [out for i, out in sorted(self.kept.items()) if i % self.pairs == k]
            low = self._reference(k, control) if control is not None else None
            turn = top = 0.0     # max |e^{i dphi} - 1| |W12_ref|, max |W12_ref|
            for lo, hi, rw, rph, mag in self._reference(k):
                if low is not None:
                    got = [next(low)[2:4]]
                else:
                    got = [(w[:, lo:hi], ph[:, lo:hi]) for w, ph in maps]
                top = max(top, float(mag.max()))
                for w, ph in got:
                    w, ph = w.to(torch.float64), ph.to(torch.float64)
                    w_gap = max(w_gap, _gap(float((w - rw).abs().max())))
                    t = 2 * torch.sin(0.5 * (ph - rph)).abs() * mag
                    turn = max(turn, _gap(float(t.max())))
            ph_gap = max(ph_gap, turn / top)
        return {"wct_gap": w_gap, "phase_gap": _gap(ph_gap)}
