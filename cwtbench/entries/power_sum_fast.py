"""``power_sum``'s calls and ``power_gap`` for a cell at the ``fast`` tier,
with its control: ``compare(control="sig4")`` puts the float64 reference
with its filtered spectrum rounded to 4 significant bits
(``reference/cwt_rounded_f64.py``), one precision below the tier's bf16 T,
in the program's place for the same calls, and reads it against the exact
reference as the program is read."""
import math

from cwtbench.entries import power_sum

LIBRARIES = power_sum.LIBRARIES


class Entry(power_sum.Entry):

    def compare(self, control=None):
        if control is None:
            return super().compare()
        from cwtbench.reference import cwt_f64
        from cwtbench.reference import cwt_rounded_f64 as rounded

        if not self.out:
            return {"power_gap": math.inf}
        sc = cwt_f64.scale_grid(self.S, self.dt, self.dj, self.s0)
        low = [rounded.power_sum(self.x[r], sc, dt=self.dt, nfft=self.nfft,
                                 f0=self.f0, bits=rounded.BITS[control])[None]
               for r in range(min(self.records, len(self.out)))]
        self.out = [low[i % self.records] for i in range(len(self.out))]
        return super().compare()
