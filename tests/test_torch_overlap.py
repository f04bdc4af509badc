"""The port's overlap-save long-signal surfaces (pycwt_torch/ops/overlap.py)
on the CPU: every single-device test of tests/test_overlap.py at its own
bound, and each surface against pycwt_tpu's on the same input (complex
surfaces 1e-10 of max|W|, planar ones 2e-5 of max, the blocked coherence
2e-4 absolute).  Also DOG's float32 spectral envelope, which overflowed
where f^m does, and the blocked coherence's phase at large N against the
JAX package's on the same inputs (``phase_figures``; run as ``python -m
tests.test_torch_overlap N [S CHUNK]`` to print them at another size)."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.ops import overlap as jov
from pycwt_torch.config import next_pow2
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import overlap as tov
from pycwt_torch.ops.mxu_dft import fft_of_real_planar
from pycwt_torch.transform import build_scale_grid, cwt_batch, icwt_batch, icwt_planar

torch.set_num_threads(2)

M6 = pt.Morlet(6)
J6 = wt.Morlet(6)
CPU = dict(device="cpu")


@pytest.fixture
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _global_w(x, scales, dt=1.0):
    W, _ = cwt_batch(torch.as_tensor(x)[None], torch.as_tensor(scales), dt,
                     mother=M6, nfft=next_pow2(len(x)))
    return W[0].numpy()


def test_halo_sizing():
    assert tov.halo_samples(10.0, 1.0) == int(np.ceil(np.sqrt(-2 * np.log(1e-7)) * 10))
    assert tov.halo_samples(10.0, 0.5) == 2 * tov.halo_samples(10.0, 1.0)
    for s, dt, eps in [(10.0, 1.0, 1e-7), (469.0, 0.25, 1e-7), (3.3, 1.0, 1e-4)]:
        assert tov.halo_samples(s, dt, eps) == jov.halo_samples(s, dt, eps)


def test_overlap_save_interior_matches_global_and_jax(f64):
    rng = np.random.default_rng(0)
    N = 4096
    x = rng.standard_normal(N)
    scales = build_scale_grid(N, 1.0, dj=0.5, s0=2.0, J=8).sj     # s_max = 32
    W_global = _global_w(x, scales)
    with pytest.warns(UserWarning, match="Nyquist"):
        W_blocked = _np(tov.cwt_overlap_save(x, scales, 1.0, mother=M6, chunk=1024,
                                             **CPU))
    assert W_blocked.shape == W_global.shape and W_blocked.dtype == np.complex128
    H = tov.halo_samples(scales.max(), 1.0)
    err = np.abs(W_blocked[:, H:N - H] - W_global[:, H:N - H])
    for i, s in enumerate(scales):
        rel = err[i].max() / np.abs(W_global[i]).max()
        if s >= 4:
            assert rel < 1e-6, (s, rel)
        else:
            nyq = float(np.exp(-0.5 * (s * np.pi - 6.0) ** 2))
            assert rel < max(10 * nyq, 1e-6), (s, rel, nyq)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W_jax = np.asarray(jov.cwt_overlap_save(x, scales, 1.0, mother=J6, chunk=1024))
    assert np.abs(W_blocked - W_jax).max() <= 1e-10 * np.abs(W_jax).max()


def test_streamed_global_power_matches_full_transform_and_jax(f64):
    rng = np.random.default_rng(3)
    N = 4096
    x = rng.standard_normal(N)
    scales = build_scale_grid(N, 1.0, dj=0.5, s0=4.0, J=6).sj     # all ≥ 4dt
    W_blocked = _np(tov.cwt_overlap_save(x, scales, 1.0, mother=M6, chunk=1024, **CPU))
    p_stream = _np(tov.streamed_global_power(x, scales, 1.0, mother=M6, chunk=1024,
                                             **CPU))
    np.testing.assert_allclose(p_stream, (np.abs(W_blocked) ** 2).sum(-1), rtol=1e-10)
    # against the circular global transform: the ~2H edge samples differ
    p_global = (np.abs(_global_w(x, scales)) ** 2).sum(-1)
    np.testing.assert_allclose(p_stream, p_global, rtol=0.05)
    p_jax = np.asarray(jov.streamed_global_power(x, scales, 1.0, mother=J6, chunk=1024))
    np.testing.assert_allclose(p_stream, p_jax, rtol=1e-10)


def test_streamed_global_power_ragged_tail(f64):
    """N not a multiple of chunk: the zero-pad tail stays out of the sum."""
    rng = np.random.default_rng(4)
    N = 3000
    x = rng.standard_normal(N)
    scales = np.array([8.0, 16.0])
    W = _np(tov.cwt_overlap_save(x, scales, 1.0, mother=M6, chunk=1024, **CPU))
    p = _np(tov.streamed_global_power(x, scales, 1.0, mother=M6, chunk=1024, **CPU))
    np.testing.assert_allclose(p, (np.abs(W) ** 2).sum(-1), rtol=1e-10)
    p_jax = np.asarray(jov.streamed_global_power(x, scales, 1.0, mother=J6, chunk=1024))
    np.testing.assert_allclose(p, p_jax, rtol=1e-10)


def test_overlap_save_short_signal_passthrough(f64):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(500)
    sj = build_scale_grid(500, 1.0, dj=0.5).sj
    with pytest.warns(UserWarning, match="Nyquist"):
        W = _np(tov.cwt_overlap_save(x, sj, 1.0, mother=M6, chunk=1 << 18, **CPU))
    np.testing.assert_allclose(W, _global_w(x, sj), rtol=0, atol=1e-12)


def test_overlap_chunk_must_be_positive():
    for fn in (tov.cwt_overlap_save, tov.cwt_overlap_save_planar):
        with pytest.raises(ValueError, match="chunk must be positive"):
            fn(np.zeros(64), [8.0], 1.0, mother=M6, chunk=0, **CPU)
    for fn in (tov.wct_overlap_planar, tov.xwt_overlap_planar):
        kw = dict(dj=0.5) if fn is tov.wct_overlap_planar else {}
        with pytest.raises(ValueError, match="chunk must be positive"):
            fn(np.zeros(64), np.zeros(64), [8.0], 1.0, mother=M6, chunk=-1, **kw, **CPU)


def test_overlap_near_nyquist_warns():
    """A grid starting near s0 = 2dt/λ warns; a coarse one (s ≥ 4dt) does
    not."""
    x = np.random.default_rng(3).standard_normal(512)
    with pytest.warns(UserWarning, match="Nyquist"):
        tov.cwt_overlap_save(x, [0.5, 2.0, 8.0], 1.0, mother=M6, chunk=256, **CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tov.cwt_overlap_save(x, torch.tensor([8.0, 16.0]), 1.0, mother=M6, chunk=256,
                             **CPU)


def test_overlap_planar_matches_complex_overlap_and_jax(f64):
    """The planar overlap-save equals the complex surface to f32 round-off
    (2e-5 of max) and the planar streamed power the full-W power sum; each
    equals pycwt_tpu's planar surface at 2e-5."""
    rng = np.random.default_rng(9)
    N = 4096
    x = rng.standard_normal(N).astype(np.float32)
    scales = np.array([8.0, 16.0, 32.0], np.float32)
    W = _np(tov.cwt_overlap_save(x, scales, 1.0, mother=M6, chunk=1024, **CPU))
    wr, wi = tov.cwt_overlap_save_planar(x, scales, 1.0, mother=M6, chunk=1024, **CPU)
    assert wr.dtype == torch.float32
    Wp = wr.numpy() + 1j * wi.numpy()
    assert Wp.shape == W.shape
    assert np.abs(Wp - W).max() < 2e-5 * np.abs(W).max()
    pw = _np(tov.streamed_global_power_planar(x, scales, 1.0, mother=M6, chunk=1024,
                                              **CPU))
    np.testing.assert_allclose(pw, (np.abs(W) ** 2).sum(axis=-1), rtol=3e-5)
    jr, ji = jov.cwt_overlap_save_planar(x, jnp.asarray(scales), 1.0, mother=J6,
                                         chunk=1024)
    Wj = np.asarray(jr) + 1j * np.asarray(ji)
    assert np.abs(Wp - Wj).max() < 2e-5 * np.abs(Wj).max()
    pj = np.asarray(jov.streamed_global_power_planar(x, jnp.asarray(scales), 1.0,
                                                     mother=J6, chunk=1024))
    np.testing.assert_allclose(pw, pj, rtol=2e-5)


def test_overlap_planar_short_signal_passthrough():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(500).astype(np.float32)
    scales = torch.tensor([8.0, 16.0])
    wr, wi = tov.cwt_overlap_save_planar(x, scales, 1.0, mother=M6, chunk=1 << 18,
                                         **CPU)
    W_ref, _ = cwt_batch(torch.tensor(x, dtype=torch.float64)[None], scales.double(),
                         1.0, mother=M6, nfft=512)
    W_ref = W_ref[0].numpy()
    got = wr.numpy() + 1j * wi.numpy()
    assert got.shape == W_ref.shape
    assert np.abs(got - W_ref).max() < 2e-5 * np.abs(W_ref).max()


def test_wct_overlap_planar_matches_global_core_and_jax(f64):
    """Each chunk's interior coherence equals the global planar core for
    s ≥ 4dt (the composed wavelet + smoothing halo) at 2e-4, phase 2e-3
    where R² > 0.2; and pycwt_tpu's blocked coherence at 2e-4."""
    from pycwt_torch.coherence import _wct_core

    rng = np.random.default_rng(21)
    N = 4096
    y1 = rng.standard_normal(N)
    y2 = 0.5 * y1 + rng.standard_normal(N)
    scales = np.array([8.0, 16.0, 32.0], np.float32)
    R, A = tov.wct_overlap_planar(y1, y2, scales, 1.0, mother=M6, dj=0.5, chunk=1024,
                                  **CPU)
    assert R.shape == (3, N) and R.dtype == torch.float32
    y1n = (y1 - y1.mean()) / y1.std()
    y2n = (y2 - y2.mean()) / y2.std()
    Rg, Ag, _ = _wct_core(torch.tensor(y1n, dtype=torch.float32)[None],
                          torch.tensor(y2n, dtype=torch.float32)[None],
                          torch.tensor(scales), 1.0, mother=M6, nfft=N, dj=0.5,
                          engine="planar")
    Rg, Ag = Rg[0].numpy(), Ag[0].numpy()
    H = 2 * tov.halo_samples(32.0, 1.0)
    sl = slice(H, N - H)
    np.testing.assert_allclose(R.numpy()[:, sl], Rg[:, sl], rtol=0, atol=2e-4)
    dphi = np.angle(np.exp(1j * (A.numpy()[:, sl] - Ag[:, sl])))
    assert np.abs(dphi[Rg[:, sl] > 0.2]).max() < 2e-3
    Rj, Aj = jov.wct_overlap_planar(y1, y2, jnp.asarray(scales), 1.0, mother=J6,
                                    dj=0.5, chunk=1024)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), rtol=0, atol=2e-4)


def test_wct_chunk_and_core_share_the_planar_body():
    """A blocked-WCT chunk and the planar WCT core run one coherence body
    (``coherence._planar_coherence``): on rows already padded to nfft, where
    the core's trim keeps every column, their R² and phase are the same
    bits."""
    from pycwt_torch.coherence import _wct_core

    rng = np.random.default_rng(4)
    nfft = 1024
    p1 = torch.tensor(rng.standard_normal(nfft), dtype=torch.float32)
    p2 = 0.5 * p1 + torch.tensor(rng.standard_normal(nfft), dtype=torch.float32)
    sc = torch.tensor([4.0, 8.0, 16.0, 32.0])
    R, A = tov._wct_chunk_pipeline(p1, p2, sc, M6, nfft, 1.0, 0.5, "highest")
    Rg, Ag, _ = _wct_core(p1, p2, sc, 1.0, mother=M6, nfft=nfft, dj=0.5,
                          engine="planar")
    assert R.shape == (4, nfft)
    assert torch.equal(R, Rg) and torch.equal(A, Ag)


def phase_figures(N: int, S: int = 64, chunk: int = 1 << 18, seed: int = 0) -> dict:
    """Each package's blocked WCT phase against its own global planar core,
    as tests/test_overlap.py:209-240 holds it, on the same seeded f32 pair
    (x, 0.5·x + noise), S scales 2·2^(j/8), dj 1/8, compared for s ≥ 4dt
    beyond the composed halo: the largest wrapped phase error where R² > 0.2
    (the JAX test's mask, ``"<pkg>_R2"``) and where also |W12| > 1e-3 of its
    max (``"<pkg>_R2_W12"``)."""
    from pycwt_torch.coherence import _wct_core
    from pycwt_tpu.coherence import _wct_core as jcore

    sj = (2.0 * 2.0 ** (np.arange(S) / 8.0)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y1 = rng.standard_normal(N).astype(np.float32)
    y2 = (0.5 * y1 + rng.standard_normal(N)).astype(np.float32)
    n1, n2 = ((y - y.mean()) / y.std() for y in (y1, y2))
    H = tov.halo_samples(float(sj.max()), 1.0)
    rows, cols = sj >= 4.0, slice(2 * H, N - 2 * H)

    def figures(R, A, Rg, Ag, W12r, W12i):
        A, Rg, Ag = (np.asarray(v, np.float64)[rows][:, cols] for v in (A, Rg, Ag))
        g12 = np.hypot(np.asarray(W12r), np.asarray(W12i))[rows][:, cols]
        dphi = np.abs(np.angle(np.exp(1j * (A - Ag))))
        m = Rg > 0.2
        return float(dphi[m].max()), float(dphi[m & (g12 > 1e-3 * g12.max())].max())

    kw = dict(dj=1 / 8, chunk=chunk)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the near-Nyquist warning of s < 4dt
        R, A = tov.wct_overlap_planar(y1, y2, sj, 1.0, mother=M6, **kw, **CPU)
        Rj, Aj = jov.wct_overlap_planar(y1, y2, jnp.asarray(sj), 1.0, mother=J6, **kw)
    Rg, Ag, (gr, gi) = _wct_core(torch.tensor(n1)[None], torch.tensor(n2)[None],
                                 torch.tensor(sj), 1.0, mother=M6, nfft=N, dj=1 / 8,
                                 engine="planar")
    Rjg, Ajg, (jr, ji) = jcore(jnp.asarray(n1)[None], jnp.asarray(n2)[None],
                               jnp.asarray(sj), 1.0, mother=J6, nfft=N, dj=1 / 8,
                               engine="planar")
    out = {}
    out["torch_R2"], out["torch_R2_W12"] = figures(R, A, Rg[0], Ag[0], gr[0], gi[0])
    out["jax_R2"], out["jax_R2_W12"] = figures(Rj, Aj, Rjg[0], Ajg[0], jr[0], ji[0])
    return out


def test_blocked_wct_phase_at_large_n_is_shared_with_jax():
    """Where R² > 0.2 alone, the blocked WCT's phase misses 2e-3 at large N
    in both packages: the angle of an unsmoothed W12 near zero is f32 noise
    in either.  At N = 2^16, 64 scales, chunk 2^14 the port's figure is no
    more than twice pycwt_tpu's on the same inputs (on the CPU the JAX
    package's is the larger, ~14×), and both hold 2e-3 where |W12| is not
    near zero."""
    fig = phase_figures(1 << 16, chunk=1 << 14)
    assert fig["torch_R2"] <= 2 * fig["jax_R2"], fig
    assert fig["jax_R2"] > 2e-3, fig
    assert fig["torch_R2_W12"] < 2e-3 and fig["jax_R2_W12"] < 2e-3, fig


@pytest.mark.parametrize("smooth_precision", [None, "high"])
def test_wct_overlap_planar_smooth_precision_runs_one_product(smooth_precision):
    """Both accepted tiers run the same f32 band product; anything else
    raises."""
    rng = np.random.default_rng(22)
    y1, y2 = rng.standard_normal((2, 1500))
    kw = dict(mother=M6, dj=0.5, chunk=512, **CPU)
    R0, A0 = tov.wct_overlap_planar(y1, y2, [8.0, 16.0], 1.0, **kw)
    R, A = tov.wct_overlap_planar(y1, y2, [8.0, 16.0], 1.0,
                                  smooth_precision=smooth_precision, **kw)
    assert torch.equal(R, R0) and torch.equal(A, A0)
    with pytest.raises(ValueError, match="smooth_precision"):
        tov.wct_overlap_planar(y1, y2, [8.0], 1.0, smooth_precision="fast", **kw)


def test_wct_overlap_planar_validates_inputs():
    with pytest.raises(ValueError, match="matching 1-D"):
        tov.wct_overlap_planar(np.zeros(100), np.zeros(50), [8.0], 1.0, mother=M6,
                               dj=0.5, **CPU)
    with pytest.raises(ValueError, match="matching 1-D"):
        tov.xwt_overlap_planar(np.zeros((2, 50)), np.zeros((2, 50)), [8.0], 1.0,
                               mother=M6, **CPU)


def test_xwt_overlap_planar_matches_global_and_jax(f64):
    """Blocked XWT interiors equal the global cross spectrum for s ≥ 4dt at
    3e-5 of max, phase 2e-3; and pycwt_tpu's blocked XWT at 2e-5 of max."""
    rng = np.random.default_rng(23)
    N = 4096
    y1 = rng.standard_normal(N)
    y2 = 0.5 * y1 + rng.standard_normal(N)
    scales = np.array([8.0, 16.0, 32.0], np.float32)
    M, A = tov.xwt_overlap_planar(y1, y2, scales, 1.0, mother=M6, chunk=1024, **CPU)
    y1n = (y1 - y1.mean()) / y1.std()
    y2n = (y2 - y2.mean()) / y2.std()
    W12 = _global_w(y1n, scales) * np.conj(_global_w(y2n, scales))
    H = tov.halo_samples(32.0, 1.0)
    sl = slice(H, N - H)
    ref = np.abs(W12)
    scale = ref.max()
    np.testing.assert_allclose(M.numpy()[:, sl], ref[:, sl], rtol=0, atol=3e-5 * scale)
    dphi = np.angle(np.exp(1j * (A.numpy()[:, sl] - np.angle(W12)[:, sl])))
    assert np.abs(dphi[ref[:, sl] > 1e-3 * scale]).max() < 2e-3
    Mj, Aj = jov.xwt_overlap_planar(y1, y2, jnp.asarray(scales), 1.0, mother=J6,
                                    chunk=1024)
    Mj = np.asarray(Mj)
    assert np.abs(M.numpy() - Mj).max() < 2e-5 * np.abs(Mj).max()


def test_icwt_planar_reconstructs_from_blocked_w():
    rng = np.random.default_rng(17)
    N = 4096
    x = rng.standard_normal(N).astype(np.float32)
    scales = torch.tensor(build_scale_grid(N, 1.0, dj=0.25, s0=2.0, J=24).sj,
                          dtype=torch.float32)
    with pytest.warns(UserWarning, match="Nyquist"):
        wr, wi = tov.cwt_overlap_save_planar(x, scales, 1.0, mother=M6, chunk=1024,
                                             **CPU)
    iw = icwt_planar(wr, scales, 1.0, 0.25, mother=M6).numpy()
    iw_c = icwt_batch(torch.complex(wr, wi), scales, 1.0, 0.25, mother=M6).numpy()
    np.testing.assert_allclose(iw, iw_c, rtol=0, atol=1e-6)
    sl = slice(512, N - 512)
    assert np.corrcoef(iw[sl], x[sl])[0, 1] > 0.85


def test_overlap_surfaces_need_a_card_by_default():
    """A numpy signal with device=None goes to the card: without one the
    call raises, naming device="cpu"; a tensor stays on its own device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = np.zeros(300)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tov.cwt_overlap_save_planar(x, [8.0], 1.0, mother=M6, chunk=128)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tov.wct_overlap_planar(x, x, [8.0], 1.0, mother=M6, dj=0.5, chunk=128)
    wr, _ = tov.cwt_overlap_save_planar(torch.zeros(300), [8.0], 1.0, mother=M6,
                                        chunk=128)
    assert wr.device.type == "cpu"


# --------------------------------------------------------------------------
# DOG's float32 envelope
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 6, 3])
def test_dog_envelope_is_zero_not_nan_at_large_f(m):
    """f^m·e^(−f²/2) in float32 is exactly 0 where e^(−f²/2) underflows
    (the naive product is inf·0 = NaN past f ≈ 2.6e6 at m = 6)."""
    f = torch.tensor([1e6, 3e6, 1e7, 1e20, -3e6, -1e20], dtype=torch.float32)
    env = pt.DOG(m).psi_ft_envelope(f)
    assert env.dtype == torch.float32
    assert bool(torch.isfinite(env).all()) and bool((env == 0).all())


@pytest.mark.parametrize("m", [2, 6, 3])
def test_dog_envelope_matches_f64_below_30(m):
    """The float32 envelope against float64 for |f| < 30 (odd m keeps the
    sign), and both against f^m·e^(−f²/2) evaluated directly in f64."""
    f = np.linspace(-30.0, 30.0, 6001)
    d = pt.DOG(m)
    e32 = d.psi_ft_envelope(torch.tensor(f, dtype=torch.float32)).double().numpy()
    e64 = d.psi_ft_envelope(torch.tensor(f, dtype=torch.float64)).numpy()
    direct = f ** m * np.exp(-0.5 * f ** 2)
    peak = np.abs(direct).max()
    assert np.abs(e64 - direct).max() <= 1e-13 * peak
    assert np.abs(e32 - e64).max() <= 2e-6 * peak
    assert e64[3000] == 0.0      # f = 0
    jax_env = np.asarray(wt.DOG(m).psi_ft_envelope(jnp.asarray(f)))
    assert np.abs(e64 - jax_env).max() <= 1e-13 * peak


def test_dog6_cwt_at_nfft_2p20_is_finite_in_f32():
    """DOG(6) at nfft 2^20 with scales up to 2·2^20: the f32 plain version of
    the kernels is finite and matches f64 at the `high` bound (2e-4 of
    max|W|)."""
    nfft = 1 << 20
    x = torch.tensor(np.random.default_rng(5).standard_normal(nfft), dtype=torch.float32)
    sr, si = fft_of_real_planar(x, nfft)
    sc = torch.tensor([2.0, 2.0 ** 10, 2.0 * nfft])
    kw = dict(mother=pt.DOG(6), nfft=nfft, dt=1.0)
    wr, wi = fc.fused_cwt_planar(sr, si, sc, **kw)
    assert bool(torch.isfinite(wr).all()) and bool(torch.isfinite(wi).all())
    rr, ri = fc._fused_cwt_planar_reference(sr.double(), si.double(), sc.double(), **kw)
    scale = float(torch.sqrt(rr ** 2 + ri ** 2).max())
    err = max(float((wr.double() - rr).abs().max()), float((wi.double() - ri).abs().max()))
    assert err <= 2e-4 * scale


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_overlap N [S CHUNK]:
    # phase_figures at a size of one's choosing (2^20, 64, 2^18 takes ~4 min
    # and ~6 GB on a CPU).
    import sys

    print(phase_figures(*(int(a) for a in sys.argv[1:])))
