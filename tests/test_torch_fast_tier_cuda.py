"""The ``fast`` tier's bf16-T kernels ``cwt_stage_a_bf16`` and
``cwt_stage_b_bf16`` on the card, at every column radix plan of
tests/test_torch_fused_cuda.py: T against its plain version rounded, stage
B against its plain version on the same T, batches against single calls,
and the launch counters of each tier.  They need an NVIDIA card and nvcc,
so they skip where there is none; ``python -m pytest
tests/test_torch_fast_tier_cuda.py`` on the card runs them."""
import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops.mxu_dft import fft_of_real_planar

torch.set_num_threads(2)

POW2 = [8, 9, 10, 11, 13, 14, 16, 18, 20, 22]
OUTPUTS = ("planes", "power", "power_sum")


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


def _ulps(a, b):
    """bf16 units in the last place between ``a`` and ``b``, elementwise:
    the distance of their bit patterns in the order of the values."""
    def key(x):
        bits = x.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (key(a) - key(b)).abs()


def _spacing(x):
    """The bf16 spacing at |x| (x bf16, normal or zero): 2^(e - 8) for
    |x| in [2^(e-1), 2^e), 0 at 0."""
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                                e - 8))


@pytest.mark.parametrize("pow2", POW2)
def test_bf16_stage_a_is_its_plain_T_rounded(cuda, pow2):
    """cwt_stage_a_bf16's T is bf16, half the f32 T's bytes, and bit for
    bit cwt_stage_a's f32 T rounded to nearest even.  Against the plain f32
    T rounded, an element may then differ where the kernel's f32 value and
    the plain one fall on two sides of a rounding boundary: by one bf16 ulp,
    or, at elements far below max|T|, by up to the f32 T's own error (1e-5
    of max|T|, test_each_kernel_matches_its_stage_reference) beyond it.  The
    shares of elements that differ, and that differ by more than one ulp,
    are printed."""
    nfft = 1 << pow2
    sr, si, sc = _inputs(nfft, True, 1, 3, cuda, seed=pow2)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
    T16 = fc.stage_a(sr, si, sc, t_dtype=torch.bfloat16, **kw)
    T32 = fc.stage_a(sr, si, sc, **kw)
    plain32 = fc._stage_a_reference(sr, si, sc, **kw)
    scale = float(torch.complex(*plain32).abs().max())
    differ = beyond = 0
    for p16, p32, pp32 in zip(T16, T32, plain32):
        pp = pp32.to(torch.bfloat16)
        assert p16.dtype == torch.bfloat16 and p16.shape == p32.shape
        assert p16.numel() * p16.element_size() * 2 == p32.numel() * p32.element_size()
        assert torch.equal(p16, p32.to(torch.bfloat16))
        gap = (p16.float() - pp.float()).abs()
        room = torch.maximum(_spacing(p16), _spacing(pp))
        assert bool((gap <= room + 1e-5 * scale).all())
        differ += int((p16 != pp).sum())
        beyond += int((_ulps(p16, pp) > 1).sum())
    n = 2 * T16[0].numel()
    print(f"2^{pow2}: {differ / n:.3e} of T's elements differ from the plain rounding, "
          f"{beyond / n:.3e} by more than one ulp")
    assert differ / n < 1e-2


@pytest.mark.parametrize("pow2", POW2)
def test_bf16_stage_b_matches_its_plain_version(cuda, pow2):
    """cwt_stage_b_bf16 on that T: within 1e-5 of max|out| of its plain
    version in every output (the widening is exact), and the f32 kernel on
    the widened T: planes and |W|² bit for bit (each column runs the same
    arithmetic), the power sums within 1e-6 of their max (at R1 = 1024 the
    bf16 wide block sums 16 columns' partials where the f32 kernel sums 8)."""
    nfft = 1 << pow2
    sr, si, sc = _inputs(nfft, True, 1, 3, cuda, seed=pow2)
    T = fc.stage_a(sr, si, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0,
                   t_dtype=torch.bfloat16)
    wide = tuple(p.to(torch.float32) for p in T)
    for output in OUTPUTS:
        got = fc.stage_b(*T, nfft=nfft, output=output)
        ref = fc._stage_b_reference(*T, nfft=nfft, output=output)
        f32 = fc.stage_b(*wide, nfft=nfft, output=output)
        if output == "planes":
            assert torch.equal(got[0], f32[0]) and torch.equal(got[1], f32[1])
            got, ref = torch.complex(*got), torch.complex(*ref)
        elif output == "power":
            assert torch.equal(got, f32)
        else:
            assert float((got - f32).abs().max()) <= 1e-6 * float(f32.abs().max())
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), output


@pytest.mark.parametrize("pow2", POW2)
def test_bf16_batch_equals_single_calls_bitwise(cuda, pow2):
    nfft = 1 << pow2
    sr, si, sc = _inputs(nfft, True, 2, 3, cuda, seed=pow2)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0, precision="fast")
    for output in OUTPUTS:
        both = fc.fused_cwt_planar(sr, si, sc, output=output, **kw)
        for b in range(2):
            one = fc.fused_cwt_planar(sr[b], si[b], sc, output=output, **kw)
            if output == "planes":
                assert torch.equal(both[0][b], one[0]) and torch.equal(both[1][b], one[1])
            else:
                assert torch.equal(both[b], one), output


@pytest.mark.parametrize("tier", ["highest", "high", "fast"])
@pytest.mark.parametrize("pow2", POW2)
def test_counters_show_each_tiers_T(cuda, pow2, tier):
    """``fast`` launches the bf16 instantiations and the other tiers the f32
    ones, once each a call; the fast result stays within the tier's 2e-2 of
    max|W| of the f32 plain version."""
    nfft = 1 << pow2
    sr, si, sc = _inputs(nfft, False, 1, 2, cuda, seed=pow2)
    fc.KERNEL_LAUNCHES.update(dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    kw = dict(mother=pt.DOG(2), nfft=nfft, dt=1.0)
    wr, wi = fc.fused_cwt_planar(sr, si, sc, precision=tier, **kw)
    bf16 = int(tier == "fast")
    assert fc.KERNEL_LAUNCHES == {
        "cwt_stage_a": 1 - bf16, "cwt_stage_b": 1 - bf16, "cwt_direct": 0,
        "cwt_stage_a_bf16": bf16, "cwt_stage_b_bf16": bf16}
    rr, ri = fc._fused_cwt_planar_reference(sr, si, sc, **kw)
    scale = float(torch.complex(rr, ri).abs().max())
    err = max(float((wr - rr).abs().max()), float((wi - ri).abs().max())) / scale
    assert err < {"highest": 1e-5, "high": 2e-4, "fast": 2e-2}[tier]


@pytest.mark.parametrize("tier", ["high", "fast"])
@pytest.mark.parametrize("pow2", [20, 22])
def test_t_points_on_the_card(cuda, pow2, tier):
    """``profiling.T_BF16_POINTS`` / ``T_F32_POINTS`` count rows × R1 × R2
    a launch of K1 at R1 = 1024 (K2-bf16's 16-column block) and 2048 (its
    cluster pair): the bench pipeline's ``power_sum`` and ``cwt_batch``'s
    complex W, each by T's element type alone."""
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.transform import cwt_batch
    from pycwt_torch.utils import profiling

    nfft = 1 << pow2
    R1, R2 = fc._nfft_factors(nfft)
    sr, si, sc = _inputs(nfft, True, 1, 3, cuda, seed=pow2)
    was_on = profiling._on
    profiling.disable_spans()
    profiling.enable_spans()
    try:
        fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0,
                            output="power_sum", precision=tier)
        x = torch.randn((1, nfft), device=cuda, generator=torch.Generator(cuda).manual_seed(pow2))
        W, _ = cwt_batch(x, sc, 1.0, mother=pt.Morlet(6), nfft=nfft,
                         config=CWTConfig(precision=tier))
        torch.cuda.synchronize()
        assert W.shape == (1, 3, nfft) and bool(torch.isfinite(W).all())
        points = 2 * 3 * R1 * R2
        fast = tier == "fast"
        assert (profiling.T_BF16_POINTS, profiling.T_F32_POINTS) == (
            points if fast else 0, 0 if fast else points)
    finally:
        profiling.disable_spans()
        profiling.enable_spans()
        if not was_on:
            profiling.disable_spans()
