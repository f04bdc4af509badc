"""Parity mode of the port (pycwt_torch/ops/twofloat.py) on the CPU: a
mirror of tests/test_twofloat.py at its bounds, and the port against
pycwt_tpu's two-float module on the same inputs.  The port computes in
native float64 (cuFFT Z2Z on the card, pocketfft here), so it meets the JAX
module's bounds with room; pycwt_tpu's jitted Stockham ladder takes seconds
to compile, so it is called at small sizes and in few cases."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_torch as pt
from pycwt_torch import transform as ttr
from pycwt_torch.ops import filterbank as tfb
from pycwt_torch.ops import twofloat as tf
from pycwt_tpu import mothers as jmothers
from pycwt_tpu.ops import twofloat as jtf
from tests.conftest import rel_err

torch.set_num_threads(2)

CPU = dict(device="cpu")


def test_eft_primitives_are_error_free():
    """two_sum/two_prod recover the exact f32 rounding error on tensors."""
    b32 = float(np.float32(1e-8))
    s, e = tf._two_sum(torch.tensor(1.0), torch.tensor(1e-8))
    assert s.dtype == torch.float32
    assert float(s) == 1.0 and float(e) == b32  # s + e == a + b EXACTLY
    a = np.float32(1.0 / 3.0)
    p, err = tf._two_prod(torch.tensor(a), torch.tensor(3.0))
    assert float(p) + float(err) == float(a) * 3.0
    # df_mul of two pairs carries the product to the pair's working precision
    xh, xl = (torch.tensor(v) for v in tf.df_from_f64(np.float64(np.pi)))
    yh, yl = (torch.tensor(v) for v in tf.df_from_f64(np.float64(np.e)))
    ph, pl = tf.df_mul(xh, xl, yh, yl)
    assert abs(float(ph) + float(pl) - np.pi * np.e) < 1e-13
    sh, sl = tf.df_sub(*tf.df_add(xh, xl, yh, yl), yh, yl)
    assert abs(float(sh) + float(sl) - np.pi) < 1e-13


def test_df_split_roundtrip():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1000) * 10.0 ** rng.integers(-6, 6, 1000)
    hi, lo = tf.df_from_f64(x)
    assert hi.dtype == lo.dtype == np.float32
    assert (np.abs(lo) <= np.spacing(np.abs(hi))).all()
    np.testing.assert_allclose(tf.df_to_f64(hi, lo), x, rtol=4e-15)


def _pairs(x):
    return (*tf.df_from_f64(x.real), *tf.df_from_f64(x.imag))


def _joined(o):
    return (tf.df_to_f64(o[0].numpy(), o[1].numpy())
            + 1j * tf.df_to_f64(o[2].numpy(), o[3].numpy()))


@pytest.mark.parametrize("N", [8, 64, 512, 4096])
def test_fft_df_matches_numpy_f64(N):
    rng = np.random.default_rng(N)
    x = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    o = tf.fft_df(*[torch.tensor(v) for v in _pairs(x)], N, -1)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in o)
    got = _joined(o)
    ref = np.fft.fft(x)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-13
    # Inverse round-trips (sign=+1 is unscaled; the caller scales by 1/N).
    back = _joined(tf.fft_df(*_pairs(got), N, +1, device="cpu")) / N  # numpy planes too
    assert np.abs(back - x).max() < 1e-13 * np.abs(x).max() + 1e-13


def test_fft_df_device_follows_the_port_rule(monkeypatch):
    """A tensor keeps its device; numpy planes with device=None go to the
    card, and without one the call raises, naming device="cpu"."""
    x = np.random.default_rng(2).standard_normal(8) + 0j
    out = tf.fft_df(*[torch.tensor(v) for v in _pairs(x)], 8)
    assert all(o.device.type == "cpu" for o in out)
    out = tf.fft_df(*_pairs(x), 8, device="cpu")
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in out)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.fft_df(*_pairs(x), 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.fft_df(*[torch.tensor(v) for v in _pairs(x)], 8, device="cuda")


@pytest.mark.parametrize("N", [8, 512])
def test_fft_df_matches_pycwt_tpu(N):
    """The same (hi, lo) planes through both packages' fft_df, both signs."""
    rng = np.random.default_rng(N + 1)
    x = rng.standard_normal((2, N)) + 1j * rng.standard_normal((2, N))
    planes = _pairs(x)
    for sign in (-1, 1):
        got = _joined(tf.fft_df(*[torch.tensor(v) for v in planes], N, sign))
        ref = _joined([torch.tensor(np.asarray(v)) for v in
                       jtf.fft_df(*[jnp.asarray(v) for v in planes], N, sign)])
        assert np.abs(got - ref).max() < 1e-13 * np.abs(ref).max()


def test_fft_df_rejects_non_pow2():
    with pytest.raises(ValueError, match="power-of-two"):
        tf.fft_df(torch.zeros(12), torch.zeros(12), torch.zeros(12),
                  torch.zeros(12), 12)
    with pytest.raises(ValueError, match="sign"):
        tf.fft_df(*[torch.zeros(8)] * 4, 8, sign=0)


@pytest.mark.parametrize("wavelet", ["morlet", "paul", "dog", "mexicanhat"])
def test_device_bank_f64_matches_jax_host_bank(wavelet):
    """The port builds the (S, nfft) bank in f64 on the device through
    ops/filterbank.py; the JAX module builds it in numpy on the host (the
    TPU has no f64).  They agree to f64 round-off on NINO3's grid."""
    m = pt.mothers.as_mother(wavelet)
    n0, dt, nfft = 504, 0.25, 512
    grid = ttr.build_scale_grid(n0, dt, mother=m)
    sj, _ = ttr.drop_reference_nan_rows(m, grid.sj, grid.freqs, nfft, dt)
    ours = tfb.filter_bank(m, torch.tensor(sj), tfb.angular_frequencies(
        nfft, dt, torch.float64), dt).numpy()
    theirs = jtf._filter_bank_f64(jmothers.as_mother(wavelet), sj, nfft, dt)
    assert ours.dtype == np.complex128
    assert np.abs(ours - theirs).max() < 1e-13 * np.abs(theirs).max()


def test_cwt_twofloat_matches_f64_golden(golden):
    g = golden("cwt_nino3_morlet6")
    W, sj, fr, coi = tf.cwt_twofloat(g["signal"], float(g["dt"]), **CPU)
    assert W.shape == g["W"].shape and W.dtype == np.complex128
    np.testing.assert_allclose(sj, g["sj"], rtol=1e-12)
    assert rel_err(np.abs(W) ** 2, np.abs(g["W"]) ** 2) < 1e-9


def test_cwt_twofloat_custom_freqs_matches_golden(golden):
    g = golden("cwt_nino3_customfreqs")
    W, sj, fr, coi = tf.cwt_twofloat(g["signal"], float(g["dt"]),
                                     freqs=g["cfreqs"], **CPU)
    assert rel_err(np.abs(W) ** 2, np.abs(g["W"]) ** 2) < 1e-9


def test_xwt_wct_twofloat_match_f64_goldens(golden):
    gx = golden("xwt_jao_jbaltic_norm1")
    W12, coi, fr = tf.xwt_twofloat(gx["y1"], gx["y2"], float(gx["dt"]), **CPU)
    assert rel_err(np.abs(W12), np.abs(gx["W12"])) < 1e-10

    gw = golden("wct_jao_jbaltic")
    WCT, aW, coi2, fr2 = tf.wct_twofloat(gw["y1"], gw["y2"], float(gw["dt"]),
                                         **CPU)
    assert rel_err(WCT, gw["WCT"]) < 1e-10
    m = gw["WCT"] > 0.5
    assert np.abs(((aW - gw["aWCT"]) + np.pi) % (2 * np.pi) - np.pi)[m].max() \
        < 1e-9


def test_twofloat_surfaces_match_pycwt_tpu(golden):
    """cwt_twofloat and wct_twofloat of the port against pycwt_tpu's on the
    same JAO/JBaltic inputs (nfft 256: one compile of the JAX ladder)."""
    gw = golden("wct_jao_jbaltic")
    dt = float(gw["dt"])
    W, sj, fr, coi = tf.cwt_twofloat(gw["y1"], dt, **CPU)
    Wj, sjj, frj, coij = jtf.cwt_twofloat(gw["y1"], dt)
    assert np.abs(W - Wj).max() < 1e-10 * np.abs(Wj).max()
    np.testing.assert_array_equal(sj, sjj)
    np.testing.assert_array_equal(coi, coij)
    WCT, aW, _, _ = tf.wct_twofloat(gw["y1"], gw["y2"], dt, **CPU)
    WCTj, aWj, _, _ = jtf.wct_twofloat(gw["y1"], gw["y2"], dt)
    assert rel_err(WCT, WCTj) < 1e-10
    m = WCTj > 0.5
    assert np.abs(((aW - aWj) + np.pi) % (2 * np.pi) - np.pi)[m].max() < 1e-9


def test_smooth_twofloat_matches_f64_smooth(golden):
    """The port's parity smoothing equals pycwt_tpu's f64 engine smoothing
    (reference mothers.py:61-104 semantics) to working precision; a complex
    field is the smoothing of its two planes."""
    from pycwt_tpu.mothers import Morlet
    from pycwt_tpu.ops.smoothing import smooth

    g = golden("smooth")
    T = np.abs(np.asarray(g["Wc"])) ** 2
    scales = np.asarray(g["scales"])
    dt, dj = float(g["dt"]), float(g["dj"])
    ours = tf.smooth_twofloat(T / scales[:, None], scales, dt, dj, pt.Morlet(6),
                              **CPU)
    ref = np.asarray(smooth(jnp.asarray(T / scales[:, None]), dt, dj,
                            jnp.asarray(scales), Morlet(6), engine="xla"))
    assert ours.dtype == np.float64
    assert rel_err(ours, ref) < 1e-11
    Wc = np.asarray(g["Wc"]) / scales[:, None]
    both = tf.smooth_twofloat(Wc, scales, dt, dj, pt.Morlet(6), **CPU)
    assert both.dtype == np.complex128
    for part, plane in ((both.real, Wc.real), (both.imag, Wc.imag)):
        np.testing.assert_allclose(part, tf.smooth_twofloat(
            plane, scales, dt, dj, pt.Morlet(6), **CPU), rtol=0, atol=1e-14)


def test_icwt_of_twofloat_w_reconstructs(golden):
    g = golden("cwt_nino3_morlet6")
    W, sj, fr, coi = tf.cwt_twofloat(g["signal"], float(g["dt"]), **CPU)
    iw = pt.icwt(W, sj, float(g["dt"]), dj=1 / 12, wavelet="morlet")
    ref = np.asarray(g["icwt"])
    assert np.abs(iw - ref).max() < 1e-10 * max(1.0, np.abs(ref).max())


def test_cwt_twofloat_batched_matches_per_signal(golden):
    g = golden("cwt_nino3_morlet6")
    y = np.asarray(g["signal"], np.float64)
    batch = np.stack([y, 0.5 * y - 1.0])
    Wb, sj, fr, coi = tf.cwt_twofloat(batch, float(g["dt"]), **CPU)
    assert Wb.shape == (2,) + g["W"].shape
    for b in range(2):
        W1, *_ = tf.cwt_twofloat(batch[b], float(g["dt"]), **CPU)
        np.testing.assert_allclose(Wb[b], W1, rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="1-D signal or a"):
        tf.cwt_twofloat(np.zeros((2, 2, 8)), 1.0, **CPU)


def test_cwt_twofloat_batch_resident_guard():
    """An oversized parity batch fails before any device work, with the JAX
    module's message, so the same call raises with or without a card."""
    with pytest.raises(ValueError, match="Split the batch"):
        tf.cwt_twofloat(np.zeros((64, 2048)), 1.0, max_bytes=1e6)
    with pytest.raises(ValueError, match="Split the batch") as jexc:
        jtf.cwt_twofloat(np.zeros((64, 2048)), 1.0, max_bytes=1e6)
    with pytest.raises(ValueError) as texc:
        tf.cwt_twofloat(np.zeros((64, 2048)), 1.0, max_bytes=1e6, **CPU)
    assert str(texc.value) == str(jexc.value)


def test_parity_mode_ignores_engine_env_and_stays_f64(monkeypatch, golden):
    """PYCWT_TPU_ENGINE=planar must not reach parity mode: every engine the
    transform and the smoothing resolve is "xla", the result is the same
    bits, nothing warns of a downcast, and every intermediate is
    f64/complex128."""
    from pycwt_torch.ops import fft as tfft
    from pycwt_torch.ops import smoothing as tsm

    g = golden("wct_jao_jbaltic")
    args = (g["y1"], g["y2"], float(g["dt"]))
    monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    W0, *_ = tf.cwt_twofloat(args[0], args[2], **CPU)
    R0, A0, *_ = tf.wct_twofloat(*args, **CPU)

    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen.append((name, out if isinstance(out, str) else out.dtype))
            return out
        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((ttr, "resolve_engine"), (tfft, "resolve_engine"),
                         (ttr, "fft_of_real_full"), (ttr, "apply_filter_bank"),
                         (ttr, "engine_ifft"), (tsm, "time_gaussian_smooth"),
                         (tsm, "scale_boxcar_same")):
        spy(module, name)
    monkeypatch.setenv("PYCWT_TPU_ENGINE", "planar")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        W1, *_ = tf.cwt_twofloat(args[0], args[2], **CPU)
        R1, A1, *_ = tf.wct_twofloat(*args, **CPU)
    np.testing.assert_array_equal(W1, W0)
    np.testing.assert_array_equal(R1, R0)
    np.testing.assert_array_equal(A1, A0)
    kinds = {name for name, _ in seen}
    assert kinds == {"resolve_engine", "fft_of_real_full", "apply_filter_bank",
                     "engine_ifft", "time_gaussian_smooth", "scale_boxcar_same"}
    assert {v for name, v in seen if name == "resolve_engine"} == {"xla"}
    assert all(v in (torch.float64, torch.complex128)
               for name, v in seen if name != "resolve_engine"), seen


def test_normalization_uses_population_std(golden):
    """normalize=True divides by numpy's std (ddof=0), as the JAX module and
    the reference do; torch.std's default (ddof=1) would scale W12 by
    n/(n-1)."""
    g = golden("xwt_jao_jbaltic_norm1")
    y1, y2, dt = np.asarray(g["y1"]), np.asarray(g["y2"]), float(g["dt"])
    n = len(y1)
    W12, *_ = tf.xwt_twofloat(y1, y2, dt, **CPU)

    def norm(y, ddof):
        return (y - y.mean()) / y.std(ddof=ddof)

    pop, *_ = tf.xwt_twofloat(norm(y1, 0), norm(y2, 0), dt, normalize=False,
                              **CPU)
    sample, *_ = tf.xwt_twofloat(norm(y1, 1), norm(y2, 1), dt, normalize=False,
                                 **CPU)
    np.testing.assert_allclose(W12, pop, rtol=1e-13, atol=1e-13 * np.abs(pop).max())
    assert rel_err(np.abs(sample) * n / (n - 1), np.abs(W12)) < 1e-12
    assert rel_err(np.abs(sample), np.abs(W12)) > 1e-3
    R, *_ = tf.wct_twofloat(y1, y2, dt, **CPU)
    Rp, *_ = tf.wct_twofloat(norm(y1, 0), norm(y2, 0), dt, normalize=False,
                             **CPU)
    np.testing.assert_allclose(R, Rp, rtol=1e-12, atol=1e-12)


def test_parity_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    y = np.random.default_rng(0).standard_normal(64)
    for call in (lambda: tf.cwt_twofloat(y, 1.0),
                 lambda: tf.xwt_twofloat(y, y, 1.0),
                 lambda: tf.wct_twofloat(y, y, 1.0),
                 lambda: tf.smooth_twofloat(np.ones((3, 8)), [1.0, 2.0, 4.0],
                                            1.0, 0.5, pt.Morlet(6))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_package_exports_parity_mode():
    import pycwt_tpu

    for name in ("cwt_twofloat", "xwt_twofloat", "wct_twofloat"):
        assert getattr(pt, name) is getattr(tf, name)
        assert name in pt.__all__ and hasattr(pycwt_tpu, name)
