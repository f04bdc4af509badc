"""The complex transform of a long record kept on the card:
``transform.cwt_batch(x[None], scales, dt, mother=Morlet(f0), nfft=nfft)``
(the f64 forward spectrum, K1 and K2 writing W planes, then their assembly
into complex64 W).  A call enqueues its work and returns W, which stays on
the device until the next call replaces it.  The last call's W and that of
one call drawn from the seed among the first 16 are kept and compared with
the float64 reference in blocks of scales: the widest gap |W - W_ref| over
max |W_ref|, ``w_gap``."""
import math

import numpy as np
import torch

from cwtbench.entries._records import RecordsEntry

LIBRARIES = ("fused_cwt",)


class Entry(RecordsEntry):
    output, kernel_output = "W", "planes"

    def __init__(self, cell, inputs, *, seed, **kw):
        from pycwt_torch.config import CWTConfig

        super().__init__(cell, inputs, seed=seed, **kw)
        self.config = CWTConfig(precision=self.precision)
        self.sample = int(np.random.default_rng(seed).integers(0, 16))
        self.kept = {}

    def call(self, i):
        from pycwt_torch.transform import cwt_batch

        W, _ = cwt_batch(self.x[i % self.records][None], self.scales, self.dt,
                         mother=self.mother, nfft=self.nfft, config=self.config)
        return W

    def keep(self, i, out):
        self.kept = {k: v for k, v in self.kept.items() if k == self.sample}
        self.kept[i] = out

    def compare(self, control=None):
        from cwtbench.reference import cwt_f64

        sc = cwt_f64.scale_grid(self.S, self.dt, self.dj, self.s0)
        gap = 0.0
        for i, W in sorted(self.kept.items()):
            if tuple(W.shape) != (1, self.S, self.n0):
                return {"w_gap": math.inf}
            num = den = 0.0
            for lo, hi, ref in cwt_f64.transform_blocks(
                    self.x[i % self.records], sc, dt=self.dt, nfft=self.nfft,
                    f0=self.f0, block=4):
                d = float((W[0, lo:hi].to(torch.complex128) - ref).abs().max())
                num = max(num, d if math.isfinite(d) else math.inf)
                den = max(den, float(ref.abs().max()))
            g = num / den
            gap = max(gap, g) if math.isfinite(g) else math.inf
        return {"w_gap": gap if self.kept else math.inf}
