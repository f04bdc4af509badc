"""One forward-spectrum rule for every f32 route into the kernels: the rows'
spectrum is taken in float64 and rounded once to the kernels' f32 planes
(``pycwt_torch/ops/fft._spectrum_f64``).  On the CPU the port runs the
kernels' plain versions: each surface is spied on where it hands its
spectrum to ``fused_cwt_planar``/``fused_cwt``, held against the f64 port
and against pycwt_tpu on the same inputs at the JAX tests' bounds, and
the routes that must agree bit for bit (``wct_matrix`` with
``sharded_wct_matrix`` on one rank, the Monte-Carlo curve across
``mc_batch`` and ``pair_block``) are checked to."""
import numpy as np
import pytest
import torch

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import coherence as jco
from pycwt_tpu.config import CWTConfig as JConfig
from pycwt_tpu.ops import overlap as jov
from pycwt_torch import coherence as tco
from pycwt_torch.config import CWTConfig, next_pow2
from pycwt_torch.examples.sample_network import make_network
from pycwt_torch.ops import fft as tfft
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import overlap as tov
from pycwt_torch.ops.mxu_dft import fft_of_real_planar
from pycwt_torch.sample import load
from pycwt_torch.transform import build_scale_grid, cwt_batch
from tests.conftest import rel_err

torch.set_num_threads(2)

PLANAR = CWTConfig(engine="planar")
F64 = CWTConfig(dtype=torch.float64)
M6 = pt.Morlet(6)
#: the network maps' bound on the planar route against the f64 port: the
#: rows' f64 spectrum gives 2.75e-4 on the CPU, an f32 one 5.83e-4
NETWORK_BOUND = 4e-4


def _f64_rounded(rows, nfft):
    """``torch.fft`` of the rows in f64, rounded once to f32 planes."""
    spec = torch.fft.fft(torch.as_tensor(rows).to(torch.float64), n=nfft)
    return spec.real.float(), spec.imag.float()


def _f32_planes(rows, nfft):
    spec = torch.fft.fft(torch.as_tensor(rows).to(torch.float32), n=nfft)
    return spec.real, spec.imag


@pytest.fixture
def spectra(monkeypatch):
    """The ``(sr, si)`` each call of ``fused_cwt_planar`` receives."""
    seen = []
    real = fc.fused_cwt_planar

    def spy(sr, si, *args, **kw):
        seen.append((sr, si))
        return real(sr, si, *args, **kw)

    monkeypatch.setattr(fc, "fused_cwt_planar", spy)
    return seen


def _assert_f64_rounded(got, rows, nfft):
    want = _f64_rounded(rows, nfft)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # and not the f32 spectrum the routes took before
    f32 = _f32_planes(rows, nfft)
    assert not (torch.equal(got[0], f32[0]) and torch.equal(got[1], f32[1]))


def _rows(B, n, seed):
    rng = np.random.default_rng(seed)
    # a trend under the noise: the steep spectrum that an f32 FFT blurs
    return (rng.standard_normal((B, n)) + np.linspace(0, 30, n)).astype(np.float32)


# --------------------------------------------------------------------------
# The spectrum each route hands to the kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows_dtype", [torch.float32, torch.float64])
def test_cwt_batch_planar_takes_the_rows_spectrum_in_f64(monkeypatch, rows_dtype):
    """cwt_batch on the planar engine: ``fused_cwt`` (the kernels on the card,
    their plain version for f32 on the CPU) gets the rows' f64 spectrum
    rounded once, and so does the returned ``signal_ft``; f64 rows keep
    their digits."""
    rows = torch.as_tensor(_rows(3, 700, 1), dtype=rows_dtype)
    nfft, sj = 1024, torch.tensor([2.0, 8.0, 32.0])
    seen = []
    real = fc.fused_cwt

    def spy(signal_ft, *args, **kw):
        seen.append(signal_ft)
        return real(signal_ft, *args, **kw)

    monkeypatch.setattr(fc, "fused_cwt", spy)
    W, ft = cwt_batch(rows, sj, 1.0, mother=M6, nfft=nfft, config=PLANAR)
    assert len(seen) == 1 and W.shape == (3, 3, 700) and W.dtype == torch.complex64
    _assert_f64_rounded((seen[0].real, seen[0].imag), rows, nfft)
    assert torch.equal(ft, seen[0])


def test_cwt_batch_xla_keeps_the_f32_spectrum():
    """The explicit ``xla``/``mxu`` engines in f32 match JAX's f32 routes:
    their spectrum stays the f32 rFFT of the rows rounded to f32."""
    rows = _rows(2, 500, 2)
    for engine in ("xla", "mxu"):
        _, ft = cwt_batch(torch.tensor(rows, dtype=torch.float64), torch.tensor([4.0]),
                          1.0, mother=M6, nfft=512, config=CWTConfig(engine=engine))
        f32 = _f32_planes(rows, 512)
        assert torch.equal(ft.real, f32[0]) and torch.equal(ft.imag, f32[1])


@pytest.mark.parametrize("nfft", [128, 1024])
def test_planar_cwt_of_real_takes_the_spectrum_in_f64(monkeypatch, nfft):
    """``_planar_cwt_of_real`` at and below the kernels' 2^8: the kernels'
    input at 1024, the plain version's below."""
    seen = []
    name = "fused_cwt_planar" if nfft >= 256 else "_fused_cwt_planar_reference"
    real = getattr(fc, name)

    def spy(sr, si, *args, **kw):
        seen.append((sr, si))
        return real(sr, si, *args, **kw)

    monkeypatch.setattr(fc, name, spy)
    rows = torch.tensor(_rows(2, nfft - 30, 3))
    fc._planar_cwt_of_real(rows, torch.tensor([2.0, 4.0]), mother=M6, nfft=nfft,
                           dt=1.0)
    assert len(seen) == 1
    _assert_f64_rounded(seen[0], rows, nfft)


def test_wct_core_planar_takes_the_rows_spectrum_in_f64(spectra):
    """``_wct_core_planar`` no longer rounds its rows to f32 before the
    transform: f64 rows reach the spectrum with all their digits."""
    y = torch.tensor(_rows(2, 600, 4), dtype=torch.float64) * (1 + 1e-9)
    sj = torch.tensor(build_scale_grid(600, 1.0, dj=1 / 4).sj)
    with pytest.warns(UserWarning, match="float32"):
        tco._wct_core(y[:1], y[1:], sj, 1.0, mother=M6, nfft=1024, dj=1 / 4,
                      engine="planar")
    assert len(spectra) == 2
    _assert_f64_rounded(spectra[0], y[:1], 1024)
    _assert_f64_rounded(spectra[1], y[1:], 1024)


def test_wct_matrix_blocks_take_the_spectrum_in_f64(spectra):
    yn = torch.tensor(_rows(4, 300, 5))
    sj = torch.tensor(build_scale_grid(300, 1.0, dj=1 / 4).sj, dtype=torch.float32)
    pairs = torch.tensor([[0, 1], [2, 3], [0, 3]])
    tco._wct_matrix_blocks(yn, pairs[:, 0], pairs[:, 1], sj, 1.0, mother=M6,
                           nfft=512, dj=1 / 4, engine="planar", block=2)
    assert len(spectra) == 1
    _assert_f64_rounded(spectra[0], yn, 512)


def test_overlap_save_chunks_take_the_spectrum_in_f64(spectra):
    """Every chunk of ``cwt_overlap_save_planar``: the slab's f64 spectrum."""
    x = torch.tensor(_rows(1, 3000, 6)[0])
    sj = torch.tensor([4.0, 8.0])
    chunk = 1024
    tov.cwt_overlap_save_planar(x, sj, 1.0, mother=M6, chunk=chunk, device="cpu")
    H = tov._halo(sj, 1.0, M6, 1e-7, chunk=chunk)
    padded, _, n_chunks = tov._pad_for_chunks(x, chunk, H)
    assert len(spectra) == n_chunks == 3
    for i, got in enumerate(spectra):
        _assert_f64_rounded(got, tov._slab(padded, i, chunk, H),
                            next_pow2(chunk + 2 * H))


def test_fft_of_real_contracts_unchanged():
    """The public spectra keep JAX's contract: the input's dtype, taken in
    it (the bench pipeline's ``fft_of_real_planar(half=True)`` on f32)."""
    x = torch.tensor(_rows(2, 256, 7))
    sr, si = fft_of_real_planar(x, 256, half=True)
    ref = torch.fft.rfft(x, n=256)[..., :128]
    assert sr.dtype == torch.float32
    assert torch.equal(sr, ref.real) and torch.equal(si, ref.imag)
    full = tfft.fft_of_real_full(x, 256)
    assert full.dtype == torch.complex64
    assert torch.equal(full, torch.fft.fft(x, n=256))


# --------------------------------------------------------------------------
# What the rule buys, and what it keeps
# --------------------------------------------------------------------------

def test_mauna_public_cwt_planar_within_5e_4_of_f64():
    """Mauna Loa's |W|² through the public ``cwt`` on the kernels' route is
    within 5e-4 of the CPU f64 port (1.28e-3 from the f32 spectrum of f32
    rows), as ``_cwt_planar_parts`` is."""
    ds = load("mauna")
    x = (ds.values - ds.values.mean()) / ds.values.std()
    W64, *_ = pt.cwt(x, ds.dt, config=F64, device="cpu")
    W, *_ = pt.cwt(x, ds.dt, config=PLANAR, device="cpu")
    assert W.dtype == np.complex64
    assert rel_err(np.abs(W) ** 2, np.abs(W64) ** 2) < 5e-4


def test_network_maps_planar_against_f64():
    """``sample_network``'s 8 stations: the planar ``wct_matrix`` maps
    within NETWORK_BOUND of the f64 complex route."""
    y = make_network()
    R64, *_ = pt.wct_matrix(y, 1.0, config=F64, device="cpu")
    R, *_ = pt.wct_matrix(y, 1.0, config=PLANAR, device="cpu")
    assert rel_err(R, R64) < NETWORK_BOUND


def test_surfaces_against_pycwt_tpu():
    """The public planar surfaces against pycwt_tpu's on the same numpy
    inputs, at the JAX tests' bounds: |W|² 5e-3 (tests/test_engines.py:156),
    coherence 1e-3 (:170), the blocked transform 2e-5 of max
    (tests/test_torch_overlap.py)."""
    g = load("nino3")
    x = (g.values - g.values.mean()) / g.values.std()
    W, *_ = pt.cwt(x, g.dt, config=PLANAR, device="cpu")
    Wj, *_ = wt.cwt(x, g.dt, config=JConfig(engine="planar"))
    assert rel_err(np.abs(W) ** 2, np.abs(np.asarray(Wj)) ** 2) < 5e-3

    y = make_network(B=4, n0=256)
    R, *_ = pt.wct(y[0], y[1], 1.0, sig=False, config=PLANAR, device="cpu")
    Rj, *_ = wt.wct(y[0], y[1], 1.0, sig=False, config=JConfig(engine="planar"))
    assert rel_err(R, np.asarray(Rj)) < 1e-3
    Rm, *_ = pt.wct_matrix(y, 1.0, config=PLANAR, device="cpu")
    Rmj, *_ = jco.wct_matrix(y, 1.0, config=JConfig(engine="planar"))
    assert rel_err(Rm, np.asarray(Rmj)) < 1e-3

    xl = _rows(1, 5000, 8)[0]
    sj = np.array([4.0, 8.0, 16.0])
    wr, wi = tov.cwt_overlap_save_planar(xl, sj, 1.0, mother=M6, chunk=2048,
                                         device="cpu")
    jr, ji = jov.cwt_overlap_save_planar(xl, sj, 1.0, mother=wt.Morlet(6),
                                         chunk=2048)
    Wl, Wlj = (wr + 1j * wi).numpy(), np.asarray(jr) + 1j * np.asarray(ji)
    assert np.abs(Wl - Wlj).max() < 2e-5 * np.abs(Wlj).max()


def test_wct_matrix_bit_for_bit_with_sharded_on_one_rank(tmp_path):
    """``wct_matrix`` and ``sharded_wct_matrix`` share ``_wct_matrix_blocks``:
    on one gloo rank and the same normalized rows they agree bit for bit."""
    import torch.distributed as dist

    from pycwt_torch.parallel import distributed, make_mesh, sharded_wct_matrix

    y = make_network(B=4, n0=256)
    yt = torch.tensor(y, dtype=torch.float32)
    yn = ((yt - yt.mean(-1, keepdim=True))
          / yt.std(-1, correction=0, keepdim=True)).numpy()
    pairs = np.array([(0, 1), (0, 2), (1, 3), (2, 3)])
    R, A, _, _, _ = pt.wct_matrix(yn, 1.0, normalize=False, pairs=pairs,
                                  pair_block=2, config=PLANAR, device="cpu")
    sj = build_scale_grid(256, 1.0, mother=M6).sj
    distributed.initialize(f"file://{tmp_path}/group", 1, 0, device="cpu")
    try:
        Rs, As = sharded_wct_matrix(make_mesh(), yt, pairs, sj, 1.0, 1 / 12,
                                    mother=M6, nfft=256, engine="planar", block=2)
        Rs, As = Rs.to_local(), As.to_local()
    finally:
        dist.destroy_process_group()
        distributed._GROUP_DEVICE.clear()
    assert np.array_equal(Rs.numpy(), R) and np.array_equal(As.numpy(), A)


def test_mc_curve_bit_identical_across_batching_on_the_planar_route():
    """The planar Monte-Carlo curve on the f64 spectrum: the same bits for
    every ``mc_batch`` and, in the batched surface, every ``pair_block``."""
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=16, mc_count=14, cache=False,
              progress=False, seed=3, config=PLANAR, device="cpu")
    curves = [tco.wct_significance(0.5, 0.6, mc_batch=b, **kw) for b in (1, 7, 14)]
    assert all(np.array_equal(c, curves[0], equal_nan=True) for c in curves[1:])
    al1, al2 = [0.5, 0.2, 0.7], [0.6, 0.3, 0.1]
    batches = [tco.wct_significance_batch(al1, al2, mc_batch=b, pair_block=p, **kw)
               for b, p in ((14, 3), (7, 1), (3, 2))]
    assert all(np.array_equal(c, batches[0], equal_nan=True) for c in batches[1:])
