"""The port's many-pair surfaces (pycwt_torch/coherence.py: xwt_pairs,
xwt_pairs_planar, wct_pairs, wct_matrix; analysis.wct_matrix_analysis) on the
CPU against pycwt_tpu on the same seeded inputs, mirroring
tests/test_coherence.py:136-379 and tests/test_analysis.py:154-180 at their
bounds.  float64 unless a planar route is named (its kernels run their plain
PyTorch versions here)."""
import numpy as np
import pytest
import torch

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.config import CWTConfig as JCWTConfig
from pycwt_torch import coherence as tco
from pycwt_torch.config import CWTConfig

torch.set_num_threads(2)

PLANAR = CWTConfig(engine="planar")


@pytest.fixture
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _close_to_max(got, ref, bound):
    """max |got − ref| within ``bound`` of max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= bound * np.abs(ref).max()


def _phase_close(got, ref, mask, bound):
    d = np.angle(np.exp(1j * (np.asarray(got) - np.asarray(ref))))
    assert np.abs(d[mask]).max() < bound


def test_wct_pairs_matches_per_pair_wct_and_jax(f64):
    rng = np.random.default_rng(11)
    B, N = 3, 240
    y1 = rng.standard_normal((B, N))
    y2 = 0.4 * y1 + rng.standard_normal((B, N))
    Wb, ab, coi, freq = pt.wct_pairs(y1, y2, 0.25, dj=1 / 8, device="cpu")
    assert Wb.shape == ab.shape and Wb.shape[0] == B
    for b in range(B):
        W1, a1, coi1, freq1, _ = pt.wct(y1[b], y2[b], 0.25, dj=1 / 8, sig=False,
                                        device="cpu")
        np.testing.assert_allclose(Wb[b], W1, rtol=0, atol=1e-10)
        np.testing.assert_allclose(ab[b], a1, rtol=0, atol=1e-10)
        np.testing.assert_allclose(coi, coi1)
        np.testing.assert_allclose(freq, freq1)
    Wj, aj, coij, freqj = wt.wct_pairs(y1, y2, 0.25, dj=1 / 8)
    np.testing.assert_allclose(Wb, Wj, rtol=0, atol=1e-10)
    _phase_close(ab, aj, np.ones(ab.shape, bool), 1e-10)
    np.testing.assert_allclose(coi, coij, rtol=1e-12)
    np.testing.assert_allclose(freq, freqj, rtol=1e-12)


def test_xwt_pairs_matches_per_pair_xwt_and_jax(f64):
    rng = np.random.default_rng(12)
    B, N = 3, 220
    y1 = rng.standard_normal((B, N))
    y2 = 0.3 * y1 + rng.standard_normal((B, N))
    Wb, coi, freq, sigb = pt.xwt_pairs(y1, y2, 0.5, dj=1 / 8, device="cpu")
    assert Wb.shape[0] == B and sigb.shape[0] == B and Wb.dtype == np.complex128
    for b in range(B):
        W1, coi1, freq1, sig1 = pt.xwt(y1[b], y2[b], 0.5, dj=1 / 8, device="cpu")
        np.testing.assert_allclose(Wb[b], W1, rtol=0, atol=1e-10)
        np.testing.assert_allclose(sigb[b], sig1, rtol=1e-12)
        np.testing.assert_allclose(coi, coi1)
    Wj, coij, freqj, sigj = wt.xwt_pairs(y1, y2, 0.5, dj=1 / 8)
    _close_to_max(Wb, Wj, 1e-10)
    np.testing.assert_allclose(sigb, sigj, rtol=1e-12)
    np.testing.assert_allclose(freq, freqj, rtol=1e-12)


@pytest.mark.parametrize("normalize", [True, False])
def test_xwt_pairs_significance_matches_jax(f64, normalize):
    """The per-pair AR(1) significance, raw-row fits and stds included."""
    rng = np.random.default_rng(13)
    y1 = 3.0 * rng.standard_normal((4, 200)) + 1.0
    y2 = 0.5 * rng.standard_normal((4, 200))
    kw = dict(dj=1 / 6, significance_level=0.8646, normalize=normalize)
    *_, sig = pt.xwt_pairs(y1, y2, 0.5, device="cpu", **kw)
    *_, sigj = wt.xwt_pairs(y1, y2, 0.5, **kw)
    np.testing.assert_allclose(sig, sigj, rtol=1e-12)


def test_xwt_pairs_planar_matches_complex_pairs_and_jax(f64):
    """Planar pairs (f32, the kernels' plain versions) against the complex
    pairs at 2e-5 of max|W12|, phase 1e-3, and against pycwt_tpu's planar
    pairs at the planar bound."""
    rng = np.random.default_rng(31)
    B, N = 5, 256
    y1 = rng.standard_normal((B, N))
    y2 = 0.4 * y1 + rng.standard_normal((B, N))
    W12, coi, freq, sig = pt.xwt_pairs(y1, y2, 0.5, dj=1 / 8, device="cpu")
    mag, phase, coi2, freq2, sig2 = pt.xwt_pairs_planar(
        y1, y2, 0.5, dj=1 / 8, config=PLANAR, pair_block=2, device="cpu")
    assert mag.dtype == np.float32 and mag.shape == W12.shape
    _close_to_max(mag, np.abs(W12), 2e-5)
    scale = np.abs(W12).max()
    _phase_close(phase, np.angle(W12), np.abs(W12) > 1e-3 * scale, 1e-3)
    np.testing.assert_allclose(sig2, sig, rtol=1e-10)
    np.testing.assert_allclose(coi2, coi)
    np.testing.assert_allclose(freq2, freq)
    magj, phasej, *_ = wt.xwt_pairs_planar(y1, y2, 0.5, dj=1 / 8,
                                           config=JCWTConfig(engine="planar"),
                                           pair_block=2)
    _close_to_max(mag, magj, 5e-5)
    _phase_close(phase, phasej, np.abs(W12) > 1e-3 * scale, 1e-3)


@pytest.mark.parametrize("block", [7, 3, 2])
def test_wct_pairs_blocking_invariant(f64, block):
    """Blocks of pairs (a ragged last one included) give the unblocked
    result to 1e-12."""
    rng = np.random.default_rng(21)
    B, N = 7, 180
    y1 = rng.standard_normal((B, N))
    y2 = 0.5 * y1 + rng.standard_normal((B, N))
    Wa, aa, coi_a, freq_a = pt.wct_pairs(y1, y2, 0.25, dj=1 / 8, pair_block=B,
                                         device="cpu")
    Wb, ab, coi_b, freq_b = pt.wct_pairs(y1, y2, 0.25, dj=1 / 8,
                                         pair_block=block, device="cpu")
    np.testing.assert_allclose(Wb, Wa, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ab, aa, rtol=0, atol=1e-12)
    np.testing.assert_allclose(coi_b, coi_a)
    np.testing.assert_allclose(freq_b, freq_a)


@pytest.mark.parametrize("block", [5, 3, 2])
def test_xwt_pairs_blocking_invariant(f64, block):
    rng = np.random.default_rng(22)
    B, N = 5, 200
    y1 = rng.standard_normal((B, N))
    y2 = rng.standard_normal((B, N))
    Wa, _, _, siga = pt.xwt_pairs(y1, y2, 0.5, dj=1 / 8, pair_block=B, device="cpu")
    Wb, _, _, sigb = pt.xwt_pairs(y1, y2, 0.5, dj=1 / 8, pair_block=block,
                                  device="cpu")
    np.testing.assert_allclose(Wb, Wa, rtol=0, atol=1e-12)
    np.testing.assert_allclose(sigb, siga, rtol=1e-12)


@pytest.mark.parametrize("block", [6, 3, 2])
def test_wct_matrix_blocking_invariant(f64, block):
    rng = np.random.default_rng(23)
    y = rng.standard_normal((4, 160))
    Wa, Aa, *_ = pt.wct_matrix(y, 0.5, dj=1 / 8, pair_block=6, device="cpu")
    Wb, Ab, *_ = pt.wct_matrix(y, 0.5, dj=1 / 8, pair_block=block, device="cpu")
    np.testing.assert_allclose(Wb, Wa, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ab, Aa, rtol=0, atol=1e-12)


def test_pairs_block_bytes_model():
    """The auto block times its bytes a pair fits the 25e9 budget, never
    exceeds B, and tiny maps give large blocks."""
    for B, S, nfft, planes in [(1024, 110, 1024, 112), (4096, 110, 1024, 48),
                               (496, 110, 8192, 24), (3, 200, 1 << 20, 112)]:
        blk = tco._pairs_block(B, S, nfft, 4, planes=planes)
        assert 1 <= blk <= B
        assert blk == 1 or blk * planes * S * nfft * 4 <= 25e9
        if blk < B:   # the largest that fits
            assert (blk + 1) * planes * S * nfft * 4 > 25e9
    assert tco._pairs_block(4, 110, 1024, 4) == 4
    assert tco._pairs_block(1024, 8, 64, 4) >= 512
    assert tco._pairs_block(10, 110, 1024, 4, budget_bytes=1.0) == 1


def test_pairs_nan_row_drop_matches_per_pair_and_jax(f64):
    """Paul at large scales drops the reference's NaN rows: the batched
    surfaces keep cwt's filtered scale axis."""
    rng = np.random.default_rng(23)
    B, N = 2, 300
    y1 = rng.standard_normal((B, N))
    y2 = rng.standard_normal((B, N))
    kw = dict(dj=1 / 8, wavelet="paul", s0=0.5, J=64)     # rows s > ~56 drop
    Wb, _, freqb, sigb = pt.xwt_pairs(y1, y2, 0.25, device="cpu", **kw)
    W0, _, freq0, sig0 = pt.xwt(y1[0], y2[0], 0.25, device="cpu", **kw)
    _, sj_cwt, freq_cwt, *_ = pt.cwt(y1[0], 0.25, device="cpu", **kw)
    assert Wb.shape[1] == W0.shape[0] == len(sj_cwt) < 65
    np.testing.assert_allclose(freqb, freq0)
    np.testing.assert_allclose(Wb[0], W0, rtol=0, atol=1e-10)
    np.testing.assert_allclose(sigb[0], sig0, rtol=1e-12)
    Wj, _, freqj, _ = wt.xwt_pairs(y1, y2, 0.25, **kw)
    _close_to_max(Wb, Wj, 1e-10)
    np.testing.assert_allclose(freqb, freqj, rtol=1e-12)
    WCT, *_ = pt.wct(y1[0], y2[0], 0.25, sig=False, device="cpu", **kw)
    Wp, _, _, freq_p = pt.wct_pairs(y1[:1], y2[:1], 0.25, device="cpu", **kw)
    assert Wp.shape[1] == len(sj_cwt)
    np.testing.assert_allclose(Wp[0], WCT, rtol=0, atol=1e-10)
    Wm, _, _, freq_m, _ = pt.wct_matrix(np.stack([y1[0], y2[0]]), 0.25,
                                        device="cpu", **kw)
    assert Wm.shape[1] == len(sj_cwt)
    np.testing.assert_allclose(freq_m, freq_cwt)
    np.testing.assert_allclose(Wm[0], WCT, rtol=0, atol=1e-10)


@pytest.mark.parametrize("fn", ["xwt_pairs_planar", "xwt_planar"])
def test_planar_non_pow2_raises(fn):
    y = np.random.default_rng(0).standard_normal((2, 300))
    y = y if fn == "xwt_pairs_planar" else y[0]
    with pytest.raises(ValueError, match="power-of-two"):
        getattr(pt, fn)(y, y, 1.0, config=CWTConfig(pad_pow2=False,
                                                    engine="planar"), device="cpu")


@pytest.mark.parametrize("fn", ["xwt_pairs", "xwt_pairs_planar", "wct_pairs"])
def test_pairs_shape_validation(fn):
    y = np.zeros((2, 256))
    with pytest.raises(ValueError, match=f"{fn} expects matching"):
        getattr(pt, fn)(y, y[:1], 1.0, device="cpu")


@pytest.mark.parametrize("engine", [None, "planar"])
def test_wct_matrix_matches_per_pair_wct_and_jax(f64, engine):
    """Every pair of the shared-transform core equals its own wct: 1e-10 on
    the complex route, 5e-5 of max on the planar (f32) one; and the same
    maps as pycwt_tpu's wct_matrix."""
    rng = np.random.default_rng(41)
    B, N = 4, 240
    y = rng.standard_normal((B, N))
    cfg = CWTConfig(engine=engine)
    if engine == "planar":
        with pytest.warns(UserWarning, match="float32"):
            WCT, aWCT, coi, freq, pairs = pt.wct_matrix(y, 0.25, dj=1 / 8, config=cfg,
                                                        pair_block=2, device="cpu")
        assert WCT.dtype == np.float32
    else:
        WCT, aWCT, coi, freq, pairs = pt.wct_matrix(y, 0.25, dj=1 / 8, config=cfg,
                                                    pair_block=2, device="cpu")
    assert len(pairs) == B * (B - 1) // 2
    for p, (i, j) in enumerate(pairs):
        Wij, aij, coi1, freq1, _ = pt.wct(y[i], y[j], 0.25, dj=1 / 8, sig=False,
                                          device="cpu")
        tol = 1e-10 if engine is None else 5e-5 * np.abs(Wij).max()
        np.testing.assert_allclose(WCT[p], Wij, rtol=0, atol=tol)
        if engine is None:
            np.testing.assert_allclose(aWCT[p], aij, rtol=0, atol=1e-10)
        else:
            _phase_close(aWCT[p], aij, Wij > 0.2, 1e-3)
    np.testing.assert_allclose(coi, coi1)
    np.testing.assert_allclose(freq, freq1)
    jcfg = JCWTConfig(engine=engine)
    Wj, Aj, _, freqj, pairsj = wt.wct_matrix(y, 0.25, dj=1 / 8, config=jcfg,
                                             pair_block=2)
    assert (pairs == pairsj).all()
    np.testing.assert_allclose(WCT, Wj, rtol=0, atol=1e-10 if engine is None else 5e-5)
    np.testing.assert_allclose(freq, freqj, rtol=1e-12)


def test_wct_matrix_explicit_pairs_and_validation(f64):
    rng = np.random.default_rng(42)
    y = rng.standard_normal((5, 200))
    sel = np.array([[0, 3], [2, 2], [4, 1]])
    WCT, aWCT, _, _, pairs = pt.wct_matrix(y, 1.0, dj=1 / 8, pairs=sel, device="cpu")
    assert WCT.shape[0] == 3 and (pairs == sel).all()
    assert np.nanmedian(WCT[1]) > 0.99        # a self-pair
    Wj, *_ = wt.wct_matrix(y, 1.0, dj=1 / 8, pairs=sel)
    np.testing.assert_allclose(WCT, Wj, rtol=0, atol=1e-10)
    for bad, match in (([[0, 7]], "out of range"), ([[-1, 0]], "out of range"),
                       (np.zeros((0, 2), int), "no pairs"), ([0, 1], r"\(P, 2\)")):
        with pytest.raises(ValueError, match=match):
            pt.wct_matrix(y, 1.0, pairs=bad, device="cpu")
    with pytest.raises(ValueError, match=r"expects \(B, n0\)"):
        pt.wct_matrix(y[0], 1.0, device="cpu")


def test_wct_matrix_resident_set_guard(f64):
    """A resident set over max_bytes raises before any work, naming the
    alternatives; the default budget admits the same request."""
    rng = np.random.default_rng(7)
    y = rng.standard_normal((6, 256))
    with pytest.raises(ValueError, match="sharded_wct_matrix"):
        pt.wct_matrix(y, 1.0, dj=1 / 8, max_bytes=1e5, device="cpu")
    WCT, *_ = pt.wct_matrix(y, 1.0, dj=1 / 8, device="cpu")
    assert np.isfinite(WCT).any()


def test_wct_matrix_as_numpy_false_returns_tensors(f64):
    rng = np.random.default_rng(12)
    y = rng.standard_normal((4, 128))
    Wn, An, coi, fr, pairs = pt.wct_matrix(y, 1.0, dj=1 / 8, device="cpu")
    Wd, Ad, coi2, fr2, pairs2 = pt.wct_matrix(y, 1.0, dj=1 / 8, as_numpy=False,
                                              device="cpu")
    assert isinstance(Wd, torch.Tensor) and isinstance(Ad, torch.Tensor)
    np.testing.assert_allclose(Wd.numpy(), Wn, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Ad.numpy(), An, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(pairs2, pairs)


def test_pair_surfaces_need_a_card_by_default():
    """device=None means the card: without one the call raises, naming
    device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    y = np.zeros((2, 64))
    for call in (lambda: pt.wct_matrix(y, 1.0), lambda: pt.wct_pairs(y, y, 1.0),
                 lambda: pt.xwt_pairs(y, y, 1.0), lambda: pt.xwt_pairs_planar(y, y, 1.0)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_wct_matrix_analysis_composes_pieces_and_matches_jax(f64):
    """wct_matrix + ar1_batch + the batched nulls, the white-noise fallback
    applied; sig95 equal to pycwt_tpu's on the same threefry members."""
    from pycwt_tpu.analysis import wct_matrix_analysis as j_wma
    from pycwt_torch.analysis import wct_matrix_analysis

    rng = np.random.default_rng(51)
    B, N = 4, 220
    y = rng.standard_normal((B, N))
    kw = dict(dj=1 / 8, mc_count=8, cache=False, seed=5)
    out = wct_matrix_analysis(y, 0.5, device="cpu", **kw)
    P = B * (B - 1) // 2
    assert out["WCT"].shape[0] == P and out["sig95"].shape[0] == P
    WCT_ref, _, _, _, pairs = pt.wct_matrix(y, 0.5, dj=1 / 8, device="cpu")
    np.testing.assert_allclose(out["WCT"], WCT_ref, atol=1e-12)
    g, _, _ = pt.ar1_batch(y)
    m = pt.Morlet(6)
    s0 = 2 * 0.5 / m.flambda()
    J = int(np.round(np.log2(N * 0.5 / s0) / (1 / 8)))
    sig_ref = tco.wct_significance_batch(g[pairs[:, 0]], g[pairs[:, 1]], dt=0.5,
                                         dj=1 / 8, s0=s0, J=J,
                                         significance_level=0.8646, mc_count=8,
                                         seed=5, cache=False, progress=False,
                                         device="cpu")
    np.testing.assert_array_equal(out["sig95"], sig_ref)
    assert out["alpha"].shape == (B,) and np.isfinite(out["alpha"]).all()
    ref = j_wma(y, 0.5, **kw)
    finite = np.isfinite(ref["sig95"])
    assert np.array_equal(finite, np.isfinite(out["sig95"]))
    np.testing.assert_allclose(out["sig95"][finite], ref["sig95"][finite], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(out["alpha"], ref["alpha"], rtol=1e-12)
    np.testing.assert_allclose(out["WCT"], ref["WCT"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(out["pairs"], ref["pairs"])


def test_wct_matrix_analysis_fallback_and_tensors(f64):
    """A degenerate AR(1) fit falls back to white noise and a strong trend is
    clipped to 0.99; sig=False gives 0; as_numpy=False keeps the maps as
    tensors."""
    from pycwt_torch.analysis import wct_matrix_analysis

    rng = np.random.default_rng(52)
    y = rng.standard_normal((3, 128))
    y[1] = np.linspace(0.0, 1.0, 128) + 1e-3 * rng.standard_normal(128)   # trend
    out = wct_matrix_analysis(y, 1.0, dj=1 / 8, sig=False, as_numpy=False,
                              device="cpu")
    assert isinstance(out["WCT"], torch.Tensor) and out["WCT"].shape[0] == 3
    np.testing.assert_array_equal(out["sig95"], [0])
    g, _, _ = pt.ar1_batch(y)
    want = np.clip(np.where(np.isfinite(g), g, 0.0), -0.99, 0.99)
    np.testing.assert_array_equal(out["alpha"], want)
    assert np.abs(out["alpha"]).max() <= 0.99
    np.testing.assert_allclose(out["period"], 1 / out["freq"])
