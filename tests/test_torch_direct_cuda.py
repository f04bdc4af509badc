"""The CUDA kernel cwt_direct (kernel K3) against its plain PyTorch version on
the card at every nfft from 2^8 to 2^12, each output from the kernel's own
epilogue, ragged scale counts and batches, the batch and counter contracts,
the gradient, and the WCT slice on K3's route.  They need an NVIDIA card and nvcc, so they skip where there
is none; ``python -m pytest --noconftest tests/test_torch_direct_cuda.py``
on the card runs them."""
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops.mxu_dft import fft_of_real_planar

torch.set_num_threads(2)

MOTHERS = [pt.Morlet(6), pt.Paul(4), pt.DOG(2), pt.DOG(6)]
#: precision tier -> bound relative to max|W| (tests/test_pallas.py:33, :198, :276)
TIER_BOUND = {"highest": 1e-5, "high": 2e-4, "fast": 2e-2}
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(nfft, half, B, S, device, seed=0):
    x = torch.tensor(np.random.default_rng(seed).standard_normal((B, nfft)),
                     dtype=torch.float32, device=device)
    sr, si = fft_of_real_planar(x, nfft, half=half)
    sc = 2.0 * 2 ** (np.arange(S) * (0.75 * np.log2(nfft) / max(S - 1, 1)))
    return sr, si, torch.tensor(sc, dtype=torch.float32, device=device)


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    mask = np.abs(b) > 1e-12 * np.nanmax(np.abs(b))
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-300))[mask].max())


@pytest.mark.parametrize("tier", sorted(TIER_BOUND))
@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
@pytest.mark.parametrize("pow2", [8, 9, 10, 11, 12])
def test_cwt_direct_matches_plain_version(cuda, pow2, output, tier):
    """37 scales: a ragged last block where rows share one (nfft < 2^10)."""
    nfft = 1 << pow2
    for m in MOTHERS:
        for half in (False, True) if m.analytic_negligible_negative() else (False,):
            sr, si, sc = _inputs(nfft, half, 1, 37, cuda, seed=pow2)
            ref = fc._direct_reference(sr, si, sc, mother=m, nfft=nfft, dt=1.0,
                                       output=output)
            got = fc.fused_cwt_planar(sr, si, sc, mother=m, nfft=nfft, dt=1.0,
                                      output=output, precision=tier,
                                      small_kernel=True)
            if output == "planes":
                scale = torch.complex(*ref).abs().max()
                err = max((got[0] - ref[0]).abs().max(), (got[1] - ref[1]).abs().max())
            else:
                scale, err = ref.abs().max(), (got - ref).abs().max()
            assert float(err) <= TIER_BOUND[tier] * float(scale), (m, half)


@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
def test_batch_equals_single_signals_bitwise(cuda, output):
    """133 scales: at 2^8 and 2^9 a row of the second signal sits elsewhere
    in its block than in a single call, and must give the same bits."""
    for nfft in (1 << 8, 1 << 9, 1 << 12):
        sr, si, sc = _inputs(nfft, False, 2, 133, cuda)
        kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output=output,
                  small_kernel=True)
        both = fc.fused_cwt_planar(sr, si, sc, **kw)
        for b in range(2):
            one = fc.fused_cwt_planar(sr[b], si[b], sc, **kw)
            if output == "planes":
                assert torch.equal(both[0][b], one[0]) and torch.equal(both[1][b], one[1])
            else:
                assert torch.equal(both[b], one), nfft


@pytest.mark.parametrize("B", [1, 2, 3])
@pytest.mark.parametrize("S", [1, 7, 37, 133])
def test_ragged_rows_every_output(cuda, S, B):
    """cwt_direct called directly: any S and B, each output within the
    `highest` bound of the plain version, at a size whose blocks hold four
    rows, two rows and one row."""
    for nfft, m, half in ((1 << 8, pt.Morlet(6), True), (1 << 9, pt.DOG(2), False),
                          (1 << 12, pt.Paul(4), False)):
        sr, si, sc = _inputs(nfft, half, B, S, cuda, seed=S + B)
        kw = dict(mother=m, nfft=nfft, dt=1.0)
        for output in ("planes", "power", "power_sum"):
            got = fc.cwt_direct(sr, si, sc, output=output, **kw)
            ref = fc._direct_reference(sr, si, sc, output=output, **kw)
            if output == "planes":
                got, ref = torch.complex(*got), torch.complex(*ref)
            assert got.shape == ref.shape == ((B, S) if output == "power_sum" else (B, S, nfft))
            assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), (nfft, output)


def test_power_sum_matches_summed_power(cuda):
    """The kernel's in-block Σ_t |W|² against its own |W|² summed by torch,
    within f32 round-off of a 4,096-term sum (2e-6 relative)."""
    for nfft in (1 << 8, 1 << 10, 1 << 12):
        sr, si, sc = _inputs(nfft, False, 2, 37, cuda)
        kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
        total = fc.cwt_direct(sr, si, sc, output="power_sum", **kw)
        summed = fc.cwt_direct(sr, si, sc, output="power", **kw).sum(-1)
        torch.testing.assert_close(total, summed, rtol=2e-6, atol=0)


def test_counters_and_dispatch(cuda, monkeypatch):
    """small_kernel launches cwt_direct at nfft ≤ 2^12 only; above, the two
    kernels run, as in the JAX package; the environment opt-in likewise."""
    fc.KERNEL_LAUNCHES.update(dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    sr, si, sc = _inputs(512, False, 1, 3, cuda)
    kw = dict(mother=pt.Morlet(6), dt=1.0)
    fc.fused_cwt_planar(sr, si, sc, nfft=512, small_kernel=True, **kw)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 0, "cwt_stage_b": 0, "cwt_direct": 1,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
    sr, si, sc = _inputs(1 << 13, False, 1, 3, cuda)
    on = fc.fused_cwt_planar(sr, si, sc, nfft=1 << 13, small_kernel=True, **kw)
    off = fc.fused_cwt_planar(sr, si, sc, nfft=1 << 13, small_kernel=False, **kw)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 1,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", "1")
    x = np.random.default_rng(2).standard_normal(504)
    pt.cwt_power(x, 0.25)
    assert fc.KERNEL_LAUNCHES["cwt_direct"] == 2


def test_gradient_through_cwt_direct(cuda):
    """At nfft = 2^12, within 1e-4 of the largest gradient
    (tests/test_autodiff.py:91-111)."""
    nfft = 1 << 12
    x0 = np.random.default_rng(3).standard_normal(nfft)
    sc0 = [4.0, 16.0, 64.0]

    def grads(fn):
        x = torch.tensor(x0, dtype=torch.float32, device=cuda, requires_grad=True)
        sc = torch.tensor(sc0, dtype=torch.float32, device=cuda, requires_grad=True)
        sr, si = fft_of_real_planar(x, nfft)
        return torch.autograd.grad(fn(sr, si, sc).sum() / nfft, (x, sc))

    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output="power_sum")
    gk = grads(lambda sr, si, sc: fc.fused_cwt_planar(sr, si, sc, small_kernel=True, **kw))
    gr = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    torch.testing.assert_close(gk[0], gr[0], rtol=0, atol=1e-4 * float(gr[0].abs().max()))
    torch.testing.assert_close(gk[1], gr[1], rtol=1e-4, atol=0)


def test_wct_via_cwt_direct_matches_golden(cuda, monkeypatch):
    """wct(sig=False) on the card through K3 (PYCWT_TPU_SMALL_KERNEL=1), at
    the f32 bound 1e-3 (tests/test_engines.py:170)."""
    g = np.load(os.path.join(GOLDEN, "wct_jao_jbaltic.npz"))
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", "1")
    fc.KERNEL_LAUNCHES.update(dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    WCT, aWCT, coi, freq, sig = pt.wct(g["y1"], g["y2"], float(g["dt"]), sig=False)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 0, "cwt_stage_b": 0, "cwt_direct": 2,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
    assert WCT.shape == g["WCT"].shape and np.isfinite(WCT).all()
    assert _rel_err(WCT, g["WCT"]) < 1e-3
