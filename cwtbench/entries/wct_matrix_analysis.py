"""All-pairs coherence of a network of stations with each pair's own
Monte-Carlo null, as an analyst's script calls it:
``pycwt_torch.analysis.wct_matrix_analysis(y, dt, dj=dj,
mother=Morlet(f0), significance_level=level, mc_count=mc_count,
seed=<run seed + call index>, cache=False)`` on the network's host array
(stations, n0), with the program's own defaults for everything else: every
i < j pair, its card, its ``high`` tier, its deduplication of the nulls and
its chunking.  The cache stays off because its entry names fold every
coefficient above 0.25 into one name: a warm call would hand all the pairs
one curve.  A call returns host arrays, so it ends synchronised.  Call i
takes network i mod N.

The warm-up makes the window's first three calls (networks 0-2), holding
their answers at once: the window holds up to three calls' maps in
page-locked host blocks (the first call's, kept, the last one's and the one
in progress), so the pool holds them all before it starts.  Each network
has its own count of distinct nulls, and so its own chunk of
``members_fit // nulls`` member pairs; the window's ~3 calls are those
three networks.
The first call's answer is kept whole, the last call's ``sig95`` and
``alpha``.  After the window they are compared with the float64 references
(``reference/wct_null_pairs_f64.py`` for the nulls and the coefficients,
``reference/wct_matrix_f64.py`` for the maps) on the run's device:

* ``sig_gap``:   the widest |sig95 - sig95_ref| over every pair of the
  first call, each pair held to the reference curve of its own null (the
  reference's deduplication of the pairs' keys), and over the pairs of
  ``check.last_nulls`` of the last call's nulls drawn from the seed; a row
  that is NaN or 0 in one has to be so in the other, else the gap is
  infinite;
* ``alpha_gap``: the widest |alpha - alpha_ref| over the kept calls'
  stations;
* ``wct_gap``, ``phase_gap``, ``grid_gap``, ``pairs_gap``: the first
  call's maps, COI, frequencies and pairs, as ``entries/wct_matrix.py``
  reads them (``map_gaps``).

An answer whose keys, shapes or dtypes are not the call's reads infinite
everywhere.  The control (``control.reference``: ``"tf32"``) puts both
references computed in TF32 in the program's place for the same calls.

``shape`` gives the call's work whatever implements it: the maps' (B, P,
S, n0, nfft, the boxcar's taps), the surrogates' grid (n, nfft, mc_count)
and each network's count of distinct nulls by the reference's own
deduplication."""
import math

import numpy as np

LIBRARIES = ("fused_cwt", "mc_noise")
NAMES = ("sig_gap", "alpha_gap", "wct_gap", "phase_gap", "grid_gap", "pairs_gap")


def _gap(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def curve_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of two curves (or stacks of them) where the
    reference's is finite; infinite where their NaN or zero rows differ."""
    got = np.asarray(got, np.float64)
    if got.shape != want.shape or not np.array_equal(np.isnan(got), np.isnan(want)) \
            or not np.array_equal(got == 0, want == 0):
        return math.inf
    m = np.isfinite(want)
    return _gap(float(np.max(np.abs(got[m] - want[m]), initial=0.0)))


class Entry:
    def __init__(self, cell, inputs, *, seed, device, precision):
        import pycwt_torch as pt
        from cwtbench import harness
        from cwtbench.reference import wct_null_pairs_f64 as NP
        from cwtbench.reference.wct_f64 import grid
        from pycwt_torch.config import DEFAULT

        if precision != DEFAULT.precision:
            raise ValueError(f"wct_matrix_analysis runs at the library's default tier "
                             f"{DEFAULT.precision!r}; it takes no other ({precision!r})")
        cfg = cell.config
        self.y = inputs["y"]
        self.networks, B, self.n0 = self.y.shape
        self.dt, self.dj, self.f0 = float(cfg["dt"]), float(cfg["dj"]), float(cfg["f0"])
        self.level = float(cfg["significance_level"])
        self.mc_count = int(cfg["mc_count"])
        self.seed = int(seed)
        self.device = device
        self.last_nulls = int(cell.spec["check"]["last_nulls"])
        self.maps = harness.load_module("entries", "wct_matrix", cell.here)
        self.kw = dict(dj=self.dj, mother=pt.Morlet(self.f0),
                       significance_level=self.level, mc_count=self.mc_count,
                       cache=False)
        if device != "cuda":
            self.kw["device"] = device
        self.pairs = NP.all_pairs(B)
        s0, J, sj, _ = grid(self.n0, self.dt, self.dj, self.f0)
        sur = NP.surrogate_grid(self.dt, self.dj, s0, J, self.f0)
        nulls = [len(NP.null_keys(NP.station_alphas(y), self.pairs, self.mc_count)[0])
                 for y in self.y]
        self.shape = {"kind": "wct_matrix_mc", "B": B, "P": len(self.pairs),
                      "S": len(sj), "n0": self.n0,
                      "nfft": 1 << (self.n0 - 1).bit_length(),
                      "taps": int(np.round(2 * self.maps.DELTAJ0 / self.dj)),
                      "n_mc": sur["n"], "nfft_mc": sur["nfft"],
                      "mc_count": self.mc_count, "nulls": nulls}
        self.first = None
        self.last = None

    def call(self, i):
        from pycwt_torch.analysis import wct_matrix_analysis

        return wct_matrix_analysis(self.y[i % self.networks], self.dt,
                                   seed=self.seed + i, **self.kw)

    def warm(self):
        outs = [self.call(i) for i in range(min(3, self.networks))]
        del outs

    def keep(self, i, out):
        if i == 0:
            self.first = out
        self.last = (i, out["sig95"], out["alpha"])

    def units(self, i):
        return 1

    def release(self):
        pass

    def _well_formed(self, out) -> bool:
        B, P, S, n0 = self.shape["B"], self.shape["P"], self.shape["S"], self.n0
        want = {"WCT": ((P, S, n0), np.float32), "phase": ((P, S, n0), np.float32),
                "sig95": ((P, S), np.float64), "alpha": ((B,), np.float64),
                "coi": ((n0,), None), "freq": ((S,), None), "pairs": (self.pairs.shape, None)}
        return isinstance(out, dict) and all(
            k in out and np.shape(out[k]) == shp
            and (dt is None or np.asarray(out[k]).dtype == dt)
            for k, (shp, dt) in want.items())

    def _nulls(self, i: int, mode: str):
        from cwtbench.reference import wct_null_pairs_f64 as NP

        return NP.Nulls(self.y[i % self.networks], self.dt, self.dj, self.f0,
                        self.mc_count, self.seed + i, self.level, self.device, mode)

    def compare(self, control=None):
        from cwtbench.reference import wct_matrix_f64 as R

        if self.first is None or self.last is None:
            return dict.fromkeys(NAMES, math.inf)
        out, (i_last, sig_last, alpha_last) = self.first, self.last
        if not self._well_formed(out) or np.shape(sig_last) != out["sig95"].shape \
                or np.shape(alpha_last) != out["alpha"].shape:
            return dict.fromkeys(NAMES, math.inf)
        gaps = dict.fromkeys(NAMES, 0.0)
        ref = {i: self._nulls(i, "f64") for i in {0, i_last}}
        low = {i: self._nulls(i, control) for i in ref} if control is not None else None

        # the first call: every pair against the curve of its own null
        got = low[0].sig95() if low else out["sig95"]
        gaps["sig_gap"] = curve_gap(got, ref[0].sig95())
        # the last call: the pairs of nulls drawn from the seed
        nl = ref[i_last]
        picks = np.random.default_rng([self.seed, 2]).choice(
            len(nl.keys), size=min(self.last_nulls, len(nl.keys)), replace=False)
        for d in sorted(int(d) for d in picks):
            rows = nl.owner == d
            got = np.asarray(sig_last)[rows]
            if low:
                got = np.broadcast_to(low[i_last].curve(d), got.shape)
            want = np.broadcast_to(nl.curve(d), got.shape)
            gaps["sig_gap"] = max(gaps["sig_gap"], curve_gap(got, want))
        for i, alpha in ((0, out["alpha"]), (i_last, alpha_last)):
            got = low[i].alpha if low else np.asarray(alpha, np.float64)
            gaps["alpha_gap"] = max(gaps["alpha_gap"],
                                    _gap(float(np.max(np.abs(got - ref[i].alpha)))))

        # the first call's maps
        y = self.y[0]
        net = R.Network(y, self.dt, self.dj, self.f0, R.Arith("f64"), self.device)
        if control is not None:
            lo_net = R.Network(y, self.dt, self.dj, self.f0, R.Arith(control), self.device)
            coi, freqs, pairs = lo_net.coi, lo_net.freqs, lo_net.pairs

            def maps(lo, hi):
                return lo_net.maps(lo_net.pairs[lo:hi, 0], lo_net.pairs[lo:hi, 1])[:2]
        else:
            coi, freqs, pairs = out["coi"], out["freq"], out["pairs"]

            def maps(lo, hi):
                return out["WCT"][lo:hi], out["phase"][lo:hi]
        gaps["wct_gap"], gaps["phase_gap"] = self.maps.map_gaps(net, maps, self.device)
        gaps["grid_gap"] = _gap(max(
            float(np.max(np.abs(np.asarray(a, np.float64) / b - 1)))
            for a, b in ((coi, net.coi), (freqs, net.freqs))))
        gaps["pairs_gap"] = float(np.any(np.asarray(pairs) != self.pairs, axis=1).sum())
        return gaps
