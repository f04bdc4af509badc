"""Kernel K3 of the port (cwt_direct, ops/fused_cwt.py) on the CPU: its plain
version against pycwt_tpu's direct-DFT Pallas kernel run in interpret mode
(as tests/test_pallas.py runs it), against the plain full-bank transform,
the mirror of the CUDA kernel's Stockham passes against both, the
small_kernel dispatch (K3 only for nfft ≤ 2^12, as pallas_fft.py:609), and
the gradient of its autograd Function."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.ops import mxu_dft as jdft
from pycwt_tpu.ops import pallas_fft as jpf
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mxu_dft as tdft

torch.set_num_threads(2)

MOTHERS = [(wt.Morlet(6), pt.Morlet(6)), (wt.Paul(4), pt.Paul(4)),
           (wt.DOG(2), pt.DOG(2)), (wt.DOG(6), pt.DOG(6))]
SPECTRA = [(j, t, half) for (j, t) in MOTHERS for half in (False, True)
           if not half or j.analytic_negligible_negative()]
SIDS = [f"{t.name}{t.f0 if isinstance(t, pt.Morlet) else t.m}-"
        f"{'half' if h else 'full'}" for _, t, h in SPECTRA]
#: five scales: not a multiple of 8 (the TPU's padding) nor of the CUDA tile
SCALES = 2.0 * 2 ** (np.arange(5) * 1.5)


def _spectrum(nfft, half, seed=0, batch=()):
    x = np.random.default_rng(seed).standard_normal(batch + (nfft,))
    return tdft.fft_of_real_planar(torch.tensor(x), nfft, half=half)


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
@pytest.mark.parametrize("nfft", [1 << p for p in range(8, 13)],
                         ids=[f"2^{p}" for p in range(8, 13)])
def test_direct_reference_matches_jax_small_kernel(nfft, spec):
    """f32 on both sides, 1e-5 of max|W|: the `highest` bound of
    tests/test_pallas.py:55 for the same kernel."""
    j, t, half = SPECTRA[spec]
    sr, si = (p.to(torch.float32) for p in _spectrum(nfft, half))
    jr, ji = jpf._fused_cwt_small(
        jnp.asarray(sr.numpy()), jnp.asarray(si.numpy()),
        jnp.asarray(SCALES, jnp.float32), mother=j, nfft=nfft, dt=0.5,
        interpret=True, precision=jax.lax.Precision.HIGHEST,
        analytic=j.analytic_negligible_negative())
    wr, wi = fc._direct_reference(sr, si, torch.tensor(SCALES, dtype=torch.float32),
                                  mother=t, nfft=nfft, dt=0.5)
    assert wr.shape == (len(SCALES), nfft) and wr.dtype == torch.float32
    ref = np.asarray(jr) + 1j * np.asarray(ji)
    got = wr.numpy() + 1j * wi.numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_direct_reference_matches_plain_transform(spec):
    """f64 against the full-bank transform: equal to f64 round-off, except
    Morlet-6 on a full spectrum, whose cut negative half (as K1 cuts it) has
    an envelope below exp(−18) = 1.5e-8."""
    _, t, half = SPECTRA[spec]
    nfft = 1 << 11
    sr, si = _spectrum(nfft, half, seed=4, batch=(2,))
    sc = torch.tensor(SCALES)
    bound = 3e-8 if isinstance(t, pt.Morlet) and not half else 1e-13
    for output in ("planes", "power", "power_sum"):
        got = fc._direct_reference(sr, si, sc, mother=t, nfft=nfft, dt=0.5,
                                   output=output)
        ref = fc._fused_cwt_planar_reference(sr, si, sc, mother=t, nfft=nfft,
                                             dt=0.5, output=output)
        if output == "planes":
            got, ref = torch.complex(*got), torch.complex(*ref)
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= bound * float(ref.abs().max())


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
@pytest.mark.parametrize("nfft", [1 << p for p in range(8, 13)],
                         ids=[f"2^{p}" for p in range(8, 13)])
def test_stockham_mirror_matches_references(nfft, spec):
    """The CUDA kernel's passes (radices, twiddle indices, output order),
    mirrored in PyTorch, against the direct-DFT plain version and against
    torch.fft.ifft of the same filtered product: f64 within 1e-12 and f32
    within 2e-6 of max|W|, for each output."""
    _, t, half = SPECTRA[spec]
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
        sr, si = (p.to(dtype) for p in _spectrum(nfft, half, seed=nfft, batch=(2,)))
        kw = dict(mother=t, nfft=nfft, dt=0.5)
        sc = torch.tensor(SCALES, dtype=dtype)
        y = fc._direct_filtered(sr, si, sc, **kw)
        W = torch.fft.ifft(torch.cat([y, y.new_zeros(y.shape[:-1] + (nfft - y.shape[-1],))],
                                     dim=-1), dim=-1)
        for output in ("planes", "power", "power_sum"):
            got = fc._direct_stockham_reference(sr, si, sc, output=output, **kw)
            refs = (fc._direct_reference(sr, si, sc, output=output, **kw),
                    fc._epilogue(W.real, W.imag, output))
            for ref in refs:
                if output == "planes":
                    g, r = torch.complex(*got), torch.complex(*ref)
                else:
                    g, r = got, ref
                assert g.shape == r.shape and g.dtype == r.dtype
                assert float((g - r).abs().max()) <= bound * float(r.abs().max()), \
                    (dtype, output)


def test_direct_radix_plan():
    """16·16 at 2^8, then a third pass of nfft/256; nothing outside 2^8..2^12."""
    for p in range(8, 13):
        plan = fc._direct_radix_plan(1 << p)
        assert plan[:2] == (16, 16) and math.prod(plan) == 1 << p
        assert len(plan) == (2 if p == 8 else 3)
    for nfft in (128, 768, 1 << 13):
        with pytest.raises(ValueError):
            fc._direct_radix_plan(nfft)


def test_small_kernel_ignored_above_2_12(monkeypatch):
    """The dispatch repair: above nfft = 2^12 small_kernel (argument or
    PYCWT_TPU_SMALL_KERNEL=1) is ignored and the K1+K2 route runs, as in
    pycwt_tpu/ops/pallas_fft.py:609; at 2^12 it selects K3's plain version.
    On the CPU no kernel launches."""
    fc.KERNEL_LAUNCHES.update(dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    sc = torch.tensor(SCALES[:3], dtype=torch.float32)
    kw = dict(mother=pt.Morlet(6), dt=1.0)
    nfft = 1 << 13
    sr, si = (p.to(torch.float32) for p in _spectrum(nfft, False))
    off = fc.fused_cwt_planar(sr, si, sc, nfft=nfft, small_kernel=False, **kw)
    on = fc.fused_cwt_planar(sr, si, sc, nfft=nfft, small_kernel=True, **kw)
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", "1")
    env = fc.fused_cwt_planar(sr, si, sc, nfft=nfft, **kw)
    for a, b, c in zip(off, on, env):
        assert torch.equal(a, b) and torch.equal(a, c)

    nfft = 1 << 12
    sr, si = (p.to(torch.float32) for p in _spectrum(nfft, False))
    direct = fc._direct_reference(sr, si, sc, nfft=nfft, **kw)
    plain = fc._fused_cwt_planar_reference(sr, si, sc, nfft=nfft, **kw)
    for got in (fc.fused_cwt_planar(sr, si, sc, nfft=nfft, **kw),
                fc.fused_cwt_planar(sr, si, sc, nfft=nfft, small_kernel=True, **kw),
                fc.cwt_direct(sr[None], si[None], sc, nfft=nfft, **kw)):
        got = tuple(g.reshape(d.shape) for g, d in zip(got, direct))
        assert all(torch.equal(g, d) for g, d in zip(got, direct))
    off = fc.fused_cwt_planar(sr, si, sc, nfft=nfft, small_kernel=False, **kw)
    assert all(torch.equal(g, d) for g, d in zip(off, plain))
    assert not torch.equal(direct[0], plain[0])
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 0, "cwt_stage_b": 0, "cwt_direct": 0,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}


@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
def test_small_kernel_outputs_and_batch(output):
    nfft = 1 << 10
    sr, si = (p.to(torch.float32) for p in _spectrum(nfft, True, seed=2, batch=(3,)))
    sc = torch.tensor(SCALES, dtype=torch.float32)
    kw = dict(mother=pt.Paul(4), nfft=nfft, dt=1.0, output=output, small_kernel=True)
    both = fc.fused_cwt_planar(sr, si, sc, **kw)
    ref = fc._direct_reference(sr, si, sc, mother=pt.Paul(4), nfft=nfft, dt=1.0,
                               output=output)
    shape = (3, len(SCALES)) + ((nfft,) if output != "power_sum" else ())
    for got, r in zip(both if output == "planes" else (both,),
                      ref if output == "planes" else (ref,)):
        assert got.shape == shape and torch.equal(got, r)
    one = fc.fused_cwt_planar(sr[1], si[1], sc, **kw)
    if output == "planes":
        torch.testing.assert_close(one[0], both[0][1], rtol=0, atol=1e-6)
    else:
        torch.testing.assert_close(one, both[1], rtol=1e-6, atol=0)


def test_direct_autograd_function_and_jax_gradient():
    """_FusedDirect on CPU tensors: forward = K3's plain version, backward =
    the plain full-bank transform's gradient; at nfft = 512 both equal JAX's
    gradient through its small kernel (tests/test_autodiff.py:91-111) within
    1e-4 of the largest gradient."""
    nfft = 512
    x0 = np.random.default_rng(4).standard_normal(nfft).astype(np.float32)
    sc0 = np.array([4.0, 16.0], np.float32)
    m = pt.Morlet(6)

    def grads(fn):
        x = torch.tensor(x0, requires_grad=True)
        sc = torch.tensor(sc0, requires_grad=True)
        sr, si = tdft.fft_of_real_planar(x, nfft)
        return torch.autograd.grad(fn(sr, si, sc).sum() / nfft, (x, sc))

    via_fn = grads(lambda sr, si, sc: fc._FusedDirect.apply(
        sr[None], si[None], sc, m, nfft, 1.0, "power_sum"))
    via_plain = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(
        sr, si, sc, mother=m, nfft=nfft, dt=1.0, output="power_sum"))
    for a, b in zip(via_fn, via_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def jloss(x):
        sr, si = jdft.fft_of_real_planar(x, nfft)
        wr, wi = jpf.fused_cwt_planar(sr, si, jnp.asarray(sc0), mother=wt.Morlet(6),
                                      nfft=nfft, dt=1.0, interpret=True,
                                      small_kernel=True)
        return (wr * wr + wi * wi).sum() / nfft

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x0)))
    np.testing.assert_allclose(via_fn[0].numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())


def test_direct_plain_version_wct_slice(monkeypatch):
    """The slice on K3's route: wct and xwt through PYCWT_TPU_SMALL_KERNEL=1
    on the CPU (K3's plain version) against the default route, at f32."""
    rng = np.random.default_rng(5)
    y1 = rng.standard_normal(300)
    y2 = 0.5 * y1 + rng.standard_normal(300)
    kw = dict(sig=False, device="cpu", config=CWTConfig(engine="planar"))
    ref, *_ = pt.wct(y1, y2, 0.5, **kw)
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", "1")
    got, *_ = pt.wct(y1, y2, 0.5, **kw)
    assert not np.array_equal(got, ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
