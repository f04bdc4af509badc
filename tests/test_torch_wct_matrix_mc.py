"""Each pair's Monte-Carlo null in ``wct_matrix_analysis`` against the
benchmark's float64 reference (``cwtbench/reference/wct_null_pairs_f64.py``),
its spans and counters, and the readers of the per-layer metrics that the
cell ``wct_matrix_mc_32st`` adds.

The network is the cell's (``cwtbench/inputs/station_network.py``) cut to
6 stations of 256 samples at the cell's settings (dt 0.25, dj 1/12,
Morlet-6, level 0.95): 15 pairs, 86 scales, surrogates of 1576 samples at
nfft 2048, with g ~ U(0.45, 0.6); at the seed here the stations' fits
(0.52-0.72) give 11 distinct nulls, of 24 members here.  The port runs cold
on the CPU in float64 (the default dtype switched, as the f64 golden tests
do).  Its card twin is ``test_torch_wct_matrix_mc_cuda.py``."""
import types
import zlib

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from cwtbench.reference import threefry, wct_f64
from cwtbench.reference import wct_null_pairs_f64 as NP
from pycwt_torch import coherence, stats
from pycwt_torch.analysis import wct_matrix_analysis
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

NETWORK = harness.load_module("inputs", "station_network").make
PARAMS = {"networks": 1, "stations": 6, "n0": 256, "g": [0.45, 0.6], "burn_in": 256,
          "period": 32, "amplitude": 1.0}
SEED = 2 ** 31 + 6007
DT, DJ, F0, LEVEL, MC = 0.25, 1 / 12, 6.0, 0.95, 24
#: float64 on both sides: the surrogates are bit for bit (the same threefry
#: words, normals and doubling scan), the transforms and smoothings differ
#: in the last bits (~1e-15 of R^2), so the counts agree unless an R^2
#: falls within that of a bin edge (1e-3 wide); at this seed they all
#: agree and the curves are equal, and 1e-12 leaves room only for the
#: readout's rounding, far under the TF32 reference's 4.95e-4 here
SIG_TOL = 1e-12
#: the fit's sums in another order (einsum against dot): ~2e-16
ALPHA_TOL = 1e-12


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the span recorder off and empty."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _stations(seed=SEED):
    return NETWORK(PARAMS, seed, "cpu")["y"][0]


#: the distinct nulls of the stations, by the reference's own deduplication
NULLS = len(NP.null_keys(NP.station_alphas(_stations()), NP.all_pairs(6), MC)[0])


def _call(y, **kw):
    return wct_matrix_analysis(y, DT, dj=DJ, mother=pt.Morlet(F0),
                               significance_level=LEVEL, mc_count=MC, seed=SEED,
                               cache=False, device="cpu", **kw)


@pytest.fixture(scope="module")
def f64_call():
    """The port's cold call in float64 with the recorder on, and the
    reference's nulls of the same call."""
    y = _stations()
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    profiling.disable_spans()
    profiling.enable_spans()
    try:
        out = _call(y)
        nulls = profiling.MC_NULLS
    finally:
        profiling.disable_spans()
        torch.set_default_dtype(saved)
    ref = NP.Nulls(y, DT, DJ, F0, MC, SEED, LEVEL, "cpu")
    return out, ref, nulls


def test_the_coefficients_match_the_reference(f64_call):
    out, ref, _ = f64_call
    assert out["alpha"].shape == (6,) and out["alpha"].dtype == np.float64
    assert np.max(np.abs(out["alpha"] - ref.alpha)) <= ALPHA_TOL


def test_every_pairs_curve_matches_its_own_null(f64_call):
    out, ref, _ = f64_call
    got, want = out["sig95"], ref.sig95()
    assert got.shape == want.shape == (15, 86)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    m = np.isfinite(want)
    assert np.max(np.abs(got[m] - want[m])) <= SIG_TOL
    # the curves are each null's, not one curve for all
    assert len({tuple(np.nan_to_num(r)) for r in got}) == NULLS


def test_the_port_and_the_reference_find_the_same_nulls(f64_call):
    out, ref, nulls = f64_call
    assert len(ref.keys) == nulls == NULLS
    for d in range(NULLS):
        rows = out["sig95"][ref.owner == d]
        assert all(np.array_equal(r, rows[0], equal_nan=True) for r in rows)


@pytest.mark.parametrize("n", [100, 147, 300])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_the_fft_smoothing_equals_the_circulant(n, kind):
    """``smooth`` by FFT against ``wct_f64.smooth``'s (n, n) circulant
    matrices, the real and imaginary parts of a complex field each."""
    rng = np.random.default_rng(n)
    sj = wct_f64.grid(n, DT, DJ, F0)[2]
    T = torch.as_tensor(rng.standard_normal((2, len(sj), n)))
    if kind == "complex":
        T = torch.complex(T, torch.as_tensor(rng.standard_normal((2, len(sj), n))))
    got = NP.smooth(T, sj, DT, DJ)
    f64 = wct_f64.Arith("f64")
    parts = [T.real, T.imag] if kind == "complex" else [T]
    want = [wct_f64.smooth(p.contiguous(), sj, DT, DJ, f64) for p in parts]
    want = torch.complex(*want) if kind == "complex" else want[0]
    assert got.dtype == want.dtype
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())


@pytest.mark.parametrize("g,slot,tau", [(0.55, 123456, 16), (0.8, 2 ** 31 - 1, 16),
                                        (-0.3, 7, 8), (0.0, 99, 0)])
def test_the_pair_keyed_rows_are_the_ports_bit_for_bit(g, slot, tau):
    """The reference's float64 surrogates against
    ``stats.rednoise_members_pairs``' CPU rows, and within rounding of the
    sequential recursion that pycwt runs."""
    key = stats.PRNGKey(SEED)
    k1, _ = stats.split(key)
    idx = torch.arange(5, 11)
    port = stats.rednoise_members_pairs(
        k1, torch.tensor([slot]), idx, 300, torch.tensor([g], dtype=torch.float64), tau,
        dtype=torch.float64)[0]
    r1, _ = threefry.split2(threefry.prng_key(SEED))
    ref = NP.members(r1, slot, idx, 300, g, tau)
    assert torch.equal(port, ref)
    s0, s1 = threefry.fold_in(r1, torch.tensor([slot]))
    z = threefry.normal_f64(threefry.fold_in((s0, s1), idx), 300 + tau).numpy()
    seq = np.empty_like(z)
    seq[:, 0] = z[:, 0]
    for t in range(1, z.shape[1]):
        seq[:, t] = g * seq[:, t - 1] + z[:, t]
    np.testing.assert_allclose(ref.numpy(), seq[:, tau:], rtol=0, atol=1e-12)


@pytest.mark.parametrize("key", [(0.6000000000000001, 0.975), (-0.45, 0.0), (0.5, 0.5)])
def test_the_slot_is_the_crc32_of_the_key(key):
    text = f"{key[0]:.17g}|{key[1]:.17g}".encode()
    assert NP.crc32(text) == zlib.crc32(text)
    assert NP.slot(key) == zlib.crc32(text) & 0x7FFFFFFF


def test_the_burn_in_and_keys_follow_the_contract():
    assert NP.alpha_quant(300) == 0.05 and NP.alpha_quant(24) == 0.05
    assert NP.alpha_quant(30000) == 0.01
    assert NP.burn_in([(0.4, 0.8)]) == 16 and NP.burn_in([(0.0, 0.0)]) == 0
    assert NP.burn_in([(0.1, 0.2)]) == 8
    keys, owner = NP.null_keys(np.array([0.61, 0.99, 0.59]), np.array([[0, 1], [0, 2], [1, 2]]), 300)
    assert keys == [(0.6000000000000001, 0.975), (0.6000000000000001, 0.6000000000000001)]
    assert owner.tolist() == [0, 1, 0]
    for a, b in keys:
        assert (a, b) == coherence._canonical_null_key(a, b, 0.05)


def _self_ns(summary, name, children):
    return summary[name]["total_ns"] - sum(summary[c]["total_ns"] for c in children)


def test_the_spans_hold_each_call():
    """``wct_matrix_analysis``, ``mc.batch`` and ``mc.readout`` once a call,
    the counts' ``fetch`` beside the maps' two; the counters add the
    distinct nulls, nulls x mc_batch x chunks members and the chunks."""
    y = _stations()
    profiling.enable_spans()
    for _ in range(2):
        out = wct_matrix_analysis(y, DT, dj=DJ, significance_level=LEVEL, mc_count=6,
                                  seed=SEED, cache=False, device="cpu")
    got = profiling.span_summary()
    for name in ("wct_matrix_analysis", "mc.batch", "mc.readout", "wct_matrix"):
        assert got[name]["count"] == 2, name
    assert got["fetch"]["count"] == 2 * 3
    top = got["wct_matrix_analysis"]
    assert got["ar1"]["count"] == 2
    assert top["self_ns"] == _self_ns(got, "wct_matrix_analysis",
                                      ("wct_matrix", "ar1", "mc.batch"))
    assert 0 < top["self_ns"] < top["total_ns"]
    assert 0 < got["mc.readout"]["total_ns"] < got["mc.batch"]["total_ns"]
    # the chunk takes all 6 members of each null (the bytes model fits far more)
    assert (profiling.MC_NULLS, profiling.MC_NULL_MEMBERS, profiling.MC_NULL_CHUNKS) \
        == (2 * NULLS, 2 * NULLS * 6 * 1, 2 * 1)
    assert out["sig95"].shape == (15, 86)
    assert profiling._stack == []


@pytest.mark.parametrize("mc_batch,chunks", [(4, 2), (6, 1), (5, 2)])
def test_the_counters_count_the_chunks_and_the_overdraw(mc_batch, chunks):
    """Member pairs drawn are nulls x mc_batch x chunks, the last chunk's
    overdraw included, whether the recorder is on or off; the curves are the
    same for any chunking; switching the recorder on sets them to 0."""
    y = _stations()
    g, _, _ = stats.ar1_batch(y)
    pairs = NP.all_pairs(6)
    s0, J, _, _ = wct_f64.grid(256, DT, DJ, F0)
    kw = dict(dt=DT, dj=DJ, s0=s0, J=J,
              significance_level=LEVEL, mc_count=6, seed=SEED, cache=False,
              progress=False, device="cpu")
    one = coherence.wct_significance_batch(g[pairs[:, 0]], g[pairs[:, 1]], **kw)
    profiling.enable_spans()
    assert profiling.MC_NULLS == profiling.MC_NULL_MEMBERS == profiling.MC_NULL_CHUNKS == 0
    profiling.disable_spans()
    got = coherence.wct_significance_batch(g[pairs[:, 0]], g[pairs[:, 1]],
                                           mc_batch=mc_batch, **kw)
    np.testing.assert_array_equal(got, one)
    assert (profiling.MC_NULLS, profiling.MC_NULL_MEMBERS, profiling.MC_NULL_CHUNKS) \
        == (NULLS, NULLS * mc_batch * chunks, chunks)
    profiling.enable_spans()
    assert profiling.MC_NULLS == profiling.MC_NULL_MEMBERS == profiling.MC_NULL_CHUNKS == 0


def test_the_single_pair_null_keeps_its_spans():
    """``wct(sig=True)`` (the cell ``wct_mc300``) runs ``mc``, not
    ``mc.batch``, and counts no null."""
    y = _stations()
    profiling.enable_spans()
    pt.wct(y[0], y[1], DT, dj=DJ, sig=True, mc_count=4, cache=False, progress=False,
           device="cpu")
    got = profiling.span_summary()
    assert got["mc"]["count"] == 1 and "mc.batch" not in got and "mc.readout" not in got
    assert profiling.MC_NULLS == 0


# --------------------------------------------------------------------------
# The cell's per-layer metrics
# --------------------------------------------------------------------------

CELL_SHAPE = {"kind": "wct_matrix_mc", "B": 32, "P": 496, "S": 110, "n0": 1024,
              "nfft": 1024, "taps": 14, "n_mc": 6302, "nfft_mc": 8192,
              "mc_count": 300, "nulls": [45, 44, 45, 46]}
SPAN_METRICS = ("mc_batch_ms.matrix_mc", "readout_host_ms.matrix_mc",
                "api_host_ms.matrix_mc", "mc_histogram_ms.matrix_mc")


def _metric(name):
    return harness.load_module("metrics", name)


def test_the_roofline_sums_the_slices_calls():
    """The bound of each call of the slice, by its network's count of nulls,
    over the device time but the copies home."""
    roof = _metric("mc_roofline_pct.matrix_mc")
    bounds = [roof.bound_s(CELL_SHAPE, k) for k in CELL_SHAPE["nulls"]]
    assert bounds[1] < bounds[0] < bounds[3]
    assert bounds[0] == pytest.approx(
        (_metric("matrix_roofline_pct").call_ops(CELL_SHAPE)
         + 45 * 300 * roof.member_ops(CELL_SHAPE)) / 67e12)
    t_us = 1e6 * (bounds[3] + bounds[0])           # calls 3 and 4
    view = types.SimpleNamespace(
        entry=types.SimpleNamespace(shape=CELL_SHAPE), first=3, last=5, calls=2,
        device_ops=[(0.0, 4 * t_us, "cwt_stage_b_kernel"),
                    (0.0, 9 * t_us, "Memcpy DtoH (Device -> Pinned)")])
    assert roof.read(view) == pytest.approx(25.0)
    idle = _metric("device_idle_pct.matrix")
    assert idle.read(types.SimpleNamespace(idle_pct=lambda: 3.5)) == 3.5


def test_the_span_metrics_read_a_call_of_the_recorder():
    mods = {n: _metric(n) for n in SPAN_METRICS + ("nulls_per_call.matrix_mc",)}
    assert profiling._on
    assert all(m.read(None) is None for m in mods.values())
    y = _stations()
    for _ in range(2):
        wct_matrix_analysis(y, DT, dj=DJ, mc_count=4, seed=SEED, cache=False, device="cpu")
    got = profiling.span_summary()
    assert mods["mc_batch_ms.matrix_mc"].read(None) == pytest.approx(
        got["mc.batch"]["total_ns"] * 1e-6 / 2)
    assert mods["readout_host_ms.matrix_mc"].read(None) == pytest.approx(
        got["mc.readout"]["total_ns"] * 1e-6 / 2)
    assert mods["api_host_ms.matrix_mc"].read(None) == pytest.approx(
        got["wct_matrix_analysis"]["self_ns"] * 1e-6 / 2)
    assert mods["mc_histogram_ms.matrix_mc"].read(None) == pytest.approx(
        got["mc.histogram"]["total_ns"] * 1e-6 / 2)
    assert mods["nulls_per_call.matrix_mc"].read(None) == NULLS
    total = got["wct_matrix_analysis"]["total_ns"] * 1e-6 / 2
    for name in SPAN_METRICS:
        assert 0 < mods[name].read(None) < total


@pytest.mark.parametrize("name", SPAN_METRICS + ("nulls_per_call.matrix_mc",))
def test_a_program_without_the_spans_or_counters_reads_nothing(name, monkeypatch):
    monkeypatch.delattr(profiling, "MC_NULLS")
    mod = _metric(name)
    with profiling.span("wct_matrix"):
        pass
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert _metric(name).read(None) is None
