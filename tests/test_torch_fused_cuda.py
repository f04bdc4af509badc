"""The CUDA kernels cwt_stage_a and cwt_stage_b against their plain PyTorch
versions on the card, at every column radix plan from 16 to 2048 points, and
the refusal of any other plan.  They need an NVIDIA card and nvcc, so they skip
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
@pytest.mark.parametrize("output", ["planes", "power", "power_sum", "complex"])
@pytest.mark.parametrize("pow2", [8, 9, 10, 11, 13, 14, 16, 18, 20, 22])
def test_kernels_match_plain_version(cuda, pow2, output, tier):
    """Every column plan from R = 16 to 2048 in both kernels (cwt_stage_a's
    length-R2 and cwt_stage_b's length-R1 columns)."""
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
    fc.KERNEL_LAUNCHES.update(dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    x = np.random.default_rng(2).standard_normal(504)
    p, sj, _, _ = pt.cwt_power(x, 0.25)
    W, *_ = pt.cwt(x, 0.25)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 0,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}
    ref, *_ = pt.cwt(x, 0.25, config=CWTConfig(engine="xla", dtype=torch.float64))
    np.testing.assert_allclose(p, np.abs(ref) ** 2, rtol=0,
                               atol=1e-5 * (np.abs(ref) ** 2).max())
    np.testing.assert_allclose(W, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # small_kernel at nfft <= 2^12 runs the direct-DFT kernel instead
    sr, si, sc = _inputs(512, False, 1, 2, cuda)
    fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), nfft=512, dt=1.0,
                        small_kernel=True)
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 2, "cwt_stage_b": 2, "cwt_direct": 1,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}


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


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
def test_each_kernel_matches_its_stage_reference(cuda, half):
    """At nfft 2^20 (16·16·4 columns): cwt_stage_a's T against
    _stage_a_reference, and cwt_stage_b's W in every output against
    _stage_b_reference on the same T, within 1e-5 of the reference's max."""
    nfft = 1 << 20
    sr, si, sc = _inputs(nfft, half, 1, 3, cuda, seed=20)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
    T = fc.stage_a(sr, si, sc, **kw)
    T_ref = torch.complex(*fc._stage_a_reference(sr, si, sc, **kw))
    assert T[0].shape == T_ref.shape == (3, 1024, 1024)
    err = float((torch.complex(*T) - T_ref).abs().max())
    assert err <= 1e-5 * float(T_ref.abs().max())
    for output in ("planes", "power", "power_sum"):
        got = fc.stage_b(*T, nfft=nfft, output=output)
        ref = fc._stage_b_reference(*T, nfft=nfft, output=output)
        if output == "planes":
            got, ref = torch.complex(*got), torch.complex(*ref)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), output


@pytest.mark.parametrize("pow2", [22, 23])
def test_wide_stage_b_matches_its_stage_reference(cuda, pow2):
    """At nfft 2^22 and 2^23 (R1 = 2048: the f32 wide block, 1024 threads
    over 8 columns): cwt_stage_b on an f32 T in every output against
    _stage_b_reference within 1e-5 of the reference's max, each launch
    counted as wide, and two rows the same bits as each row alone."""
    nfft = 1 << pow2
    R1, R2 = fc._nfft_factors(nfft)
    sr, si, sc = _inputs(nfft, True, 1, 2, cuda, seed=pow2)
    T = fc.stage_a(sr, si, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0)
    assert T[0].shape == (2, R1, R2) and R1 == 2048
    for output in ("planes", "power", "power_sum"):
        wide = fc.STAGE_B_WIDE_LAUNCHES
        got = fc.stage_b(*T, nfft=nfft, output=output)
        assert fc.STAGE_B_WIDE_LAUNCHES == wide + 1
        ref = fc._stage_b_reference(*T, nfft=nfft, output=output)
        one = [fc.stage_b(T[0][i:i + 1], T[1][i:i + 1], nfft=nfft, output=output)
               for i in range(2)]
        if output == "planes":
            for i in range(2):
                assert torch.equal(got[0][i], one[i][0][0])
                assert torch.equal(got[1][i], one[i][1][0])
            got, ref = torch.complex(*got), torch.complex(*ref)
        else:
            assert torch.equal(got, torch.cat(one)), output
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max()), output
        del got, ref, one


@pytest.mark.parametrize("t_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("pow2, S", [(20, 64), (22, 16)], ids=["2^20x64", "2^22x16"])
def test_complex_epilogue_equals_assembled_planes(cuda, pow2, S, t_dtype):
    """K2's ``complex`` epilogue stores ``torch.complex`` of its ``planes``
    bit for bit, at R1 = 1024 and at R1 = 2048 (the wide block), on an f32
    and a bf16 T of S > 1 rows; each launch counted once in
    ``STAGE_B_COMPLEX_LAUNCHES``, a ``planes`` launch not."""
    nfft = 1 << pow2
    sr, si, sc = _inputs(nfft, True, 1, S, cuda, seed=pow2)
    T = fc.stage_a(sr, si, sc, mother=pt.Morlet(6), nfft=nfft, dt=1.0, t_dtype=t_dtype)
    assert T[0].shape == (S,) + fc._nfft_factors(nfft) and T[0].dtype == t_dtype
    n = fc.STAGE_B_COMPLEX_LAUNCHES
    got = fc.stage_b(*T, nfft=nfft, output="complex")
    assert fc.STAGE_B_COMPLEX_LAUNCHES == n + 1
    want = torch.complex(*fc.stage_b(*T, nfft=nfft, output="planes"))
    assert fc.STAGE_B_COMPLEX_LAUNCHES == n + 1
    assert got.shape == (S, nfft) and got.dtype == torch.complex64
    assert torch.equal(got, want)


def test_cwt_batch_takes_the_complex_epilogue(cuda):
    """``cwt_batch`` at 2^22 runs K2 in the ``complex`` epilogue, one launch
    a call, and its W is ``torch.complex`` of the ``planes`` epilogue on the
    same spectrum, bit for bit; ``power_sum`` does not count."""
    from pycwt_torch.ops.fft import _spectrum_f64
    from pycwt_torch.transform import cwt_batch

    nfft = 1 << 22
    x = torch.tensor(np.random.default_rng(22).standard_normal((1, nfft)),
                     dtype=torch.float32, device=cuda)
    sc = torch.tensor([2.0, 16.0, 128.0], device=cuda)
    n = fc.STAGE_B_COMPLEX_LAUNCHES
    for i in range(2):
        W, _ = cwt_batch(x, sc, 1.0, mother=pt.Morlet(6), nfft=nfft)
        assert fc.STAGE_B_COMPLEX_LAUNCHES == n + i + 1
    spec = _spectrum_f64(x, nfft)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
    planes = fc.fused_cwt_planar(spec.real.contiguous(), spec.imag.contiguous(), sc,
                                 output="planes", **kw)
    assert W.dtype == torch.complex64 and torch.equal(W, torch.complex(*planes))
    fc.fused_cwt_planar(spec.real.contiguous(), spec.imag.contiguous(), sc,
                        output="power_sum", **kw)
    assert fc.STAGE_B_COMPLEX_LAUNCHES == n + 2


def test_wrong_radix_plan_refused(cuda):
    """Each kernel launches only with _column_radix_plan's plan: any other
    returns cudaErrorInvalidValue (1) and writes nothing."""
    from pycwt_torch.ops._build import library

    lib = library("fused_cwt")
    nfft = 1 << 20
    R1, R2 = fc._nfft_factors(nfft)
    sr, si, sc = _inputs(nfft, True, 1, 1, cuda)
    tr = torch.zeros((1, R1, R2), device=cuda)
    ti = torch.zeros_like(tr)
    out = torch.zeros((1, nfft), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    good = fc._plan_args(R2)
    assert good == (16, 16, 4, 1)
    for plan in [(16, 16, 2, 2), (16, 4, 16, 1), (4, 16, 16, 1), (16, 16, 4, 2), (1024, 1, 1, 1)]:
        err_a = lib.cwt_stage_a(sr.data_ptr(), si.data_ptr(), nfft // 2, sc.data_ptr(),
                                tr.data_ptr(), ti.data_ptr(), 1, 1, R1, R2, R2 // 2,
                                fc._tile_cols(R2, R1), 0, 6.0, 0, 1.0, 0.0, 1.0,
                                2 * np.pi / nfft, *plan, stream)
        err_b = lib.cwt_stage_b(tr.data_ptr(), ti.data_ptr(), out.data_ptr(), None, 1,
                                R1, R2, fc._tile_cols(R1, R2), 1, 1.0 / nfft, *plan, stream)
        assert (err_a, err_b) == (1, 1), plan
    torch.cuda.synchronize()
    assert not tr.any() and not out.any()
    assert lib.cwt_stage_b(tr.data_ptr(), ti.data_ptr(), out.data_ptr(), None, 1, R1, R2,
                           fc._tile_cols(R1, R2), 1, 1.0 / nfft, *good, stream) == 0
