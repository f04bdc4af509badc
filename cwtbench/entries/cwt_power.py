"""The public wavelet power of one long host record, as an analyst's
script calls it: ``pycwt_torch.cwt_power(x, dt, dj=dj, s0=s0, J=J,
wavelet=mother)`` with the configuration's values, which are pycwt's
defaults, and the program's own defaults for everything else (its card,
its ``high`` tier).  On the card that runs the f64 spectrum, K1 and K2
with the ``power`` epilogue, the slice to the record's n0 samples and the
copy of |W|^2 to a new numpy array, so a call ends synchronised.  Call i
takes record i mod R.

Keeping every call's power would hold a gigabyte of host memory a call, so
the last call's answer and those of ``check.samples`` calls drawn from the
seed among the first 16 are kept, and compared after the window with the
float64 reference of their record (``reference/cwt_power_f64.py``), whose
grid is worked out from the configuration alone:

* ``p_gap``:    the widest, over scales and kept calls, of
  max_t |P - P_ref| / max_t P_ref, once the power's shape (S, n0) and
  dtype float32 are checked (infinite otherwise);
* ``grid_gap``: the widest relative gap of ``sj``, ``freqs`` and ``coi``.

The control (``control.precision``: ``"fast"``) runs the program at that
tier in the same calls."""
import math

import numpy as np
import torch

from cwtbench import kernel_bounds

LIBRARIES = ("fused_cwt",)
#: calls among which the kept ones are drawn
DRAWN = 16


def _gap(x: float) -> float:
    return x if math.isfinite(x) else math.inf


class Entry:
    def __init__(self, cell, inputs, *, seed, device, precision):
        from cwtbench.reference import cwt_power_f64 as R
        from pycwt_torch.config import DEFAULT, CWTConfig

        cfg = cell.config
        self.x = inputs["x"]
        self.records, self.n0 = self.x.shape
        self.dt, self.f0 = float(cfg["dt"]), float(cfg["f0"])
        self.dj, self.s0, self.J = float(cfg["dj"]), cfg["s0"], int(cfg["J"])
        self.device = device
        self.kw = dict(dj=self.dj, s0=self.s0, J=self.J, wavelet=cfg["mother"])
        if precision != DEFAULT.precision:
            self.kw["config"] = CWTConfig(precision=precision)
        if device != "cuda":
            self.kw["device"] = device
        self.grid = R.grid(self.n0, self.dt, self.dj, self.f0, self.s0, self.J)
        nfft = 1 << (self.n0 - 1).bit_length()
        self.shape = {"kind": "cwt_power", "B": 1, "n0": self.n0, "nfft": nfft,
                      "n_in": nfft, "S": len(self.grid[0]), "output": "power",
                      "kernel_output": "power"}
        samples = int(cell.spec.get("check", {}).get("samples", 1))
        self.drawn = {int(k) for k in np.random.default_rng(seed).choice(
            DRAWN, size=samples, replace=False)}
        self.kept = {}
        self.last = None

    def call(self, i):
        import pycwt_torch as pt

        return pt.cwt_power(self.x[i % self.records], self.dt, **self.kw)

    def warm(self):
        for i in range(2):
            self.call(i)

    def keep(self, i, out):
        if self.last is not None and self.last not in self.drawn:
            self.kept.pop(self.last, None)
        self.kept[i] = out
        self.last = i

    def units(self, i):
        return 1

    def kernel_bounds(self):
        return kernel_bounds.k1_k2(self.shape, self.shape["n_in"])

    def release(self):
        pass

    def compare(self, control=None):
        from cwtbench.reference import cwt_power_f64 as R

        if not self.kept:
            return {"p_gap": math.inf, "grid_gap": math.inf}
        sj, freqs, coi = self.grid
        gaps = {"p_gap": 0.0, "grid_gap": 0.0}
        for i, (P, got_sj, got_freqs, got_coi) in sorted(self.kept.items()):
            P = np.asarray(P)
            if (P.shape != (len(sj), self.n0) or P.dtype != np.float32
                    or np.shape(got_sj) != sj.shape
                    or np.shape(got_freqs) != freqs.shape
                    or np.shape(got_coi) != coi.shape):
                return {k: math.inf for k in gaps}
            grid = max(float(np.max(np.abs(np.asarray(got, np.float64) / ref.numpy() - 1)))
                       for got, ref in ((got_sj, sj), (got_freqs, freqs), (got_coi, coi)))
            gaps["grid_gap"] = max(gaps["grid_gap"], _gap(grid))
            x = torch.as_tensor(self.x[i % self.records], device=self.device)
            for lo, hi, ref in R.power_blocks(x, sj, dt=self.dt, f0=self.f0):
                got = torch.as_tensor(P[lo:hi]).to(device=self.device,
                                                   dtype=torch.float64)
                row = (got - ref).abs().amax(dim=1) / ref.amax(dim=1)
                gaps["p_gap"] = max(gaps["p_gap"], _gap(float(row.max())))
        return gaps
