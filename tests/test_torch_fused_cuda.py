"""The CUDA kernels cwt_stage_a and cwt_stage_b against their plain PyTorch
versions on the card.  They need an NVIDIA card and nvcc, so they skip
where there is none; ``python -m pytest tests/test_torch_fused_cuda.py`` on
the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops.mxu_dft import fft_of_real_planar

torch.set_num_threads(2)

MOTHERS = [pt.Morlet(6), pt.Paul(4), pt.DOG(2), pt.DOG(6)]
#: precision tier -> bound relative to max|W| (tests/test_pallas.py:33, :198, :276)
TIER_BOUND = {"highest": 1e-5, "high": 2e-4, "fast": 2e-2}


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
    # scales up to 2·nfft^(3/4): DOG's f^m stays finite in f32
    sc = 2.0 * 2 ** (np.arange(S) * (0.75 * np.log2(nfft) / max(S - 1, 1)))
    return sr, si, torch.tensor(sc, dtype=torch.float32, device=device)


@pytest.mark.parametrize("tier", sorted(TIER_BOUND))
@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
@pytest.mark.parametrize("pow2", [8, 10, 13, 14, 16, 20])
def test_kernels_match_plain_version(cuda, pow2, output, tier):
    nfft = 1 << pow2
    for m in MOTHERS:
        for half in (False, True) if m.analytic_negligible_negative() else (False,):
            sr, si, sc = _inputs(nfft, half, 1, 4, cuda, seed=pow2)
            ref = fc._fused_cwt_planar_reference(sr, si, sc, mother=m, nfft=nfft,
                                                 dt=1.0, output=output)
            got = fc.fused_cwt_planar(sr, si, sc, mother=m, nfft=nfft, dt=1.0,
                                      output=output, precision=tier)
            if output == "planes":
                scale = torch.complex(*ref).abs().max()
                err = max((got[0] - ref[0]).abs().max(), (got[1] - ref[1]).abs().max())
            else:
                scale, err = ref.abs().max(), (got - ref).abs().max()
            assert float(err) <= TIER_BOUND[tier] * float(scale), (m, half)


@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
def test_batch_equals_single_signals_bitwise(cuda, output):
    nfft = 1 << 14
    sr, si, sc = _inputs(nfft, True, 2, 5, cuda)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output=output)
    both = fc.fused_cwt_planar(sr, si, sc, **kw)
    for b in range(2):
        one = fc.fused_cwt_planar(sr[b], si[b], sc, **kw)
        if output == "planes":
            assert torch.equal(both[0][b], one[0]) and torch.equal(both[1][b], one[1])
        else:
            assert torch.equal(both[b], one)


def test_counters_small_kernel_and_public_path(cuda):
    fc.KERNEL_LAUNCHES.update(cwt_stage_a=0, cwt_stage_b=0, cwt_direct=0)
    x = np.random.default_rng(2).standard_normal(504)
    p, sj, _, _ = pt.cwt_power(x, 0.25)
    W, *_ = pt.cwt(x, 0.25)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 0}
    ref, *_ = pt.cwt(x, 0.25, config=CWTConfig(engine="xla", dtype=torch.float64))
    np.testing.assert_allclose(p, np.abs(ref) ** 2, rtol=0,
                               atol=1e-5 * (np.abs(ref) ** 2).max())
    np.testing.assert_allclose(W, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # small_kernel at nfft <= 2^12 runs the direct-DFT kernel instead
    sr, si, sc = _inputs(512, False, 1, 2, cuda)
    fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), nfft=512, dt=1.0,
                        small_kernel=True)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 1}


def test_gradients_through_kernels(cuda):
    nfft = 1 << 14
    x0 = np.random.default_rng(3).standard_normal(nfft)
    sc0 = [4.0, 16.0, 64.0]

    def grads(fn):
        x = torch.tensor(x0, dtype=torch.float32, device=cuda, requires_grad=True)
        sc = torch.tensor(sc0, dtype=torch.float32, device=cuda, requires_grad=True)
        sr, si = fft_of_real_planar(x, nfft)
        loss = fn(sr, si, sc).sum() / nfft
        return torch.autograd.grad(loss, (x, sc))

    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, output="power_sum")
    gk = grads(lambda sr, si, sc: fc.fused_cwt_planar(sr, si, sc, **kw))
    gr = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    torch.testing.assert_close(gk[0], gr[0], rtol=0,
                               atol=1e-4 * float(gr[0].abs().max()))
    torch.testing.assert_close(gk[1], gr[1], rtol=1e-4, atol=0)
