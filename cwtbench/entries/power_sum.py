"""The global wavelet spectrum of a long record by direct sum, the port's
main-path pipeline: ``fft_of_real_planar(x, nfft, half=True)`` (cuFFT) then
``fused_cwt_planar(..., output="power_sum")`` (K1 ``cwt_stage_a``, K2
``cwt_stage_b``).  A call enqueues its work and returns; calls go back to
back on one stream.  Every call's S sums are kept and each is compared with
the float64 reference of its record: the widest relative gap over scales
and calls, ``power_gap``."""
import math

import torch

from cwtbench.entries._records import RecordsEntry

LIBRARIES = ("fused_cwt",)


class Entry(RecordsEntry):
    output = kernel_output = "power_sum"

    def __init__(self, cell, inputs, **kw):
        super().__init__(cell, inputs, **kw)
        self.out = []

    def call(self, i):
        from pycwt_torch.ops.fused_cwt import fused_cwt_planar
        from pycwt_torch.ops.mxu_dft import fft_of_real_planar

        sr, si = fft_of_real_planar(self.x[i % self.records][None], self.nfft,
                                    half=True)
        return fused_cwt_planar(sr, si, self.scales, mother=self.mother,
                                nfft=self.nfft, dt=self.dt, output="power_sum",
                                precision=self.precision)

    def keep(self, i, out):
        self.out.append(out)

    def compare(self, control=None):
        from cwtbench.reference import cwt_f64

        got = torch.cat(self.out).double() if self.out else None
        if got is None or tuple(got.shape) != (len(self.out), self.S):
            return {"power_gap": math.inf}
        sc = cwt_f64.scale_grid(self.S, self.dt, self.dj, self.s0)
        gap = 0.0
        for r in range(min(self.records, len(self.out))):
            ref = cwt_f64.power_sum(self.x[r], sc, dt=self.dt, nfft=self.nfft,
                                    f0=self.f0)
            g = float(((got[r::self.records] - ref).abs() / ref).max())
            gap = max(gap, g) if math.isfinite(g) else math.inf
        return {"power_gap": gap}
