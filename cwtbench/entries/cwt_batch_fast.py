"""``cwt_batch``'s calls and ``w_gap`` for a cell at the ``fast`` tier, with
its control: ``compare(control="sig4")`` puts the float64 reference with its
filtered spectrum rounded to 4 significant bits
(``reference/cwt_rounded_f64.py``), one precision below the tier's bf16 T,
in the place of each kept call's W, and reads it against the exact
reference block by block as the program's W is read."""
import math

from cwtbench.entries import cwt_batch

LIBRARIES = cwt_batch.LIBRARIES


class Entry(cwt_batch.Entry):

    def compare(self, control=None):
        if control is None:
            return super().compare()
        from cwtbench.reference import cwt_f64
        from cwtbench.reference import cwt_rounded_f64 as rounded

        sc = cwt_f64.scale_grid(self.S, self.dt, self.dj, self.s0)
        gap = 0.0
        for i in sorted(self.kept):
            x = self.x[i % self.records]
            kw = dict(dt=self.dt, nfft=self.nfft, f0=self.f0, block=4)
            num = den = 0.0
            for (lo, hi, ref), (_, _, low) in zip(
                    cwt_f64.transform_blocks(x, sc, **kw),
                    rounded.transform_blocks(x, sc, bits=rounded.BITS[control], **kw)):
                num = max(num, float((low - ref).abs().max()))
                den = max(den, float(ref.abs().max()))
            gap = max(gap, num / den)
        return {"w_gap": gap if self.kept else math.inf}
