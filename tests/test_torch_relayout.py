"""cwt_stage_b's ablation variants (pycwt_torch/tools/relayout_experiment.py)
on the CPU, through their plain PyTorch versions: the ``full`` variant
against pycwt_tpu's kernel B in interpret mode, and each ablated variant
against an independent numpy construction in float64 at every column length
from 16 to 2048 points (both R1 = 1024's plan 16·16·4 and R1 = 2048's
16·16·8).

The port's ablated variants are not compared with the JAX tool's
(tools/tpu_relayout_experiment.py): the TPU's kernel B is a matmul DFT whose
ablations drop a twiddle multiply and a transpose between two dot
substages, while cwt_stage_b is a Stockham FFT whose ablations drop the
twiddles and the shared-memory exchange between its radix passes.  The two
take different stages out, so their wrong numbers differ; only ``full``,
the real transform, has a JAX counterpart."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.ops import mxu_dft as jdft
from pycwt_tpu.ops import pallas_fft as jpf
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.tools import relayout_experiment as rx

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECTRA = [(wt.Morlet(6), pt.Morlet(6), True), (wt.Paul(4), pt.Paul(4), False),
           (wt.DOG(2), pt.DOG(2), False)]
SIDS = ["Morlet6-half", "Paul4-full", "DOG2-full"]
SCALES = 2.0 * 2 ** (np.arange(6) * 1.5)
ABLATED = ("notwiddle", "noexchange", "butterflies")


# --------------------------------------------------------------------------
# Independent constructions in numpy, float64, along the last axis
# --------------------------------------------------------------------------

def _idft(x, axis=-1):
    """The unscaled inverse DFT along ``axis``."""
    return np.fft.ifft(x, axis=axis) * x.shape[axis]


def _np_notwiddle(x, plan):
    """Stockham passes without twiddles are the multidimensional DFT over
    the radix digits (first radix outermost), read out with the digits
    reversed."""
    lead, k = x.shape[:-1], len(plan)
    y = x.reshape(lead + tuple(plan))
    for ax in range(len(lead), len(lead) + k):
        y = _idft(y, ax)
    order = tuple(range(len(lead))) + tuple(reversed(range(len(lead), len(lead) + k)))
    return y.transpose(order).reshape(x.shape)


def _np_per_thread(x, plan, twiddle):
    """Each of the R/16 threads of a column, one at a time: its 16 points
    x[lt + r·R/16], every pass on them (twiddles of lt + q·R/16 when
    ``twiddle``), the output of register q·RL + r to lt + q·R/16 + r·R/RL."""
    R = x.shape[-1]
    TC, RL = R // 16, plan[-1]
    out = np.empty_like(x)
    for lt in range(TC):
        v = x[..., lt::TC].copy()
        ns = 1
        for rad in plan:
            for q in range(16 // rad):
                seg = v[..., q * rad:(q + 1) * rad]
                if twiddle:
                    seg = seg * np.exp(2j * np.pi * ((lt + q * TC) % ns)
                                       * np.arange(rad) / (ns * rad))
                v[..., q * rad:(q + 1) * rad] = _idft(seg)
            ns *= rad
        for q in range(16 // RL):
            for r in range(RL):
                out[..., lt + q * TC + r * (R // RL)] = v[..., q * RL + r]
    return out


def _np_permutation(x, plan):
    """Register q·RL + r of thread lt, loaded from lt + (q·RL + r)·R/16,
    stored at lt + q·R/16 + r·R/RL."""
    R = x.shape[-1]
    TC, RL = R // 16, plan[-1]
    out = np.empty_like(x)
    for lt in range(TC):
        for q in range(16 // RL):
            for r in range(RL):
                out[..., lt + q * TC + r * (R // RL)] = x[..., lt + (q * RL + r) * TC]
    return out


def _np_variant(x, variant):
    plan = fc._column_radix_plan(x.shape[-1])
    if variant == "full":
        return _idft(x)
    if variant == "notwiddle":
        return _np_notwiddle(x, plan)
    if variant in ("noexchange", "butterflies"):
        return _np_per_thread(x, plan, twiddle=variant == "noexchange")
    return _np_permutation(x, plan)


def _columns(R, n=3, seed=0):
    rng = np.random.default_rng(seed + R)
    return rng.standard_normal((n, R)) + 1j * rng.standard_normal((n, R))


# --------------------------------------------------------------------------
# Tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_full_variant_matches_jax_kernel_b(spec):
    """At nfft 2^14, float32: T from stage A on the kernels' column passes,
    then ``ablated_stage_b(variant="full")`` on the CPU against pycwt_tpu's
    kernels A and B in interpret mode, within 1e-5 of max|W|."""
    j, t, half = SPECTRA[spec]
    nfft = 1 << 14
    x = np.random.default_rng(spec).standard_normal(nfft).astype(np.float32)
    sr, si = (np.asarray(a) for a in jdft.fft_of_real_planar(jnp.asarray(x), nfft,
                                                             half=half))
    T = fc._stage_a_reference(torch.tensor(sr)[None], torch.tensor(si)[None],
                              torch.tensor(SCALES, dtype=torch.float32), mother=t,
                              nfft=nfft, dt=1.0, column_fft=fc._column_stockham)
    ref = jpf.fused_cwt_planar(jnp.asarray(sr), jnp.asarray(si),
                               jnp.asarray(SCALES, jnp.float32), mother=j, nfft=nfft,
                               dt=1.0, interpret=True, Ablk=32, Cblk=32,
                               precision="highest", output="planes")
    ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    wr, wi = rx.ablated_stage_b(*T, nfft=nfft, variant="full")
    assert wr.dtype == torch.float32 and wr.shape == (len(SCALES), nfft)
    got = wr.numpy() + 1j * wi.numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("variant", ["full", *ABLATED])
@pytest.mark.parametrize("log_r", range(4, 12))
def test_ablated_column_matches_numpy(log_r, variant):
    """Each variant's column FFT (``_ablated_column``) in float64 against
    its numpy construction, within 1e-12 of max|out|: the inverse DFT,
    twiddle-free passes, per-thread passes with and without twiddles."""
    x = _columns(1 << log_r)
    got = fc._ablated_column(torch.tensor(x), -1, variant).numpy()
    ref = _np_variant(x, variant)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("log_r", range(4, 12))
def test_memcopy_column_is_the_thread_permutation(log_r):
    x = _columns(1 << log_r)
    got = fc._ablated_column(torch.tensor(x), -1, "memcopy").numpy()
    assert np.array_equal(got, _np_permutation(x, fc._column_radix_plan(1 << log_r)))


@pytest.mark.parametrize("variant", ["full", *ABLATED, "memcopy"])
@pytest.mark.parametrize("pow2", [8, 9, 14, 20])
def test_stage_b_ablation_reference_layout(pow2, variant):
    """The variants at stage B's layout in float64: T ``(rows, R1, R2)``,
    the column transform along R1, W[c + R2·d] = out_c[d] / N; within 1e-12
    of max|W| of the numpy construction, memcopy exactly."""
    nfft = 1 << pow2
    R1, R2 = fc._nfft_factors(nfft)
    rows = 2 if pow2 < 20 else 1
    rng = np.random.default_rng(pow2)
    tr, ti = rng.standard_normal((2, rows, R1, R2))
    cols = np.moveaxis(tr + 1j * ti, 1, -1)               # (rows, R2, R1)
    ref = np.moveaxis(_np_variant(cols, variant), -1, 1).reshape(rows, nfft) / nfft
    wr, wi = fc._stage_b_ablation_reference(torch.tensor(tr), torch.tensor(ti),
                                            nfft=nfft, variant=variant)
    got = wr.numpy() + 1j * wi.numpy()
    if variant == "memcopy":
        assert np.array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_entry_point_runs_plain_versions_on_cpu_uncounted():
    """On CPU tensors ``ablated_stage_b`` returns each plain version and
    counts no launch; ``full`` equals stage B on the kernels' passes."""
    nfft = 1 << 12
    T = rx.make_t(nfft, 3, seed=1, device="cpu")
    assert T[0].shape == (3, 64, 64) and T[0].dtype == torch.float32
    before = dict(rx.LAUNCHES), dict(fc.KERNEL_LAUNCHES)
    for v in rx.VARIANTS:
        got = rx.ablated_stage_b(*T, nfft=nfft, variant=v)
        ref = fc._stage_b_ablation_reference(*T, nfft=nfft, variant=v)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), v
    full = fc._stage_b_reference(*T, nfft=nfft, output="planes",
                                 column_fft=fc._column_stockham)
    got = rx.ablated_stage_b(*T, nfft=nfft, variant="full")
    assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    assert (dict(rx.LAUNCHES), dict(fc.KERNEL_LAUNCHES)) == before


def test_ablated_stage_b_refuses_bad_input():
    nfft = 1 << 12
    tr = torch.zeros((2, 64, 64))
    with pytest.raises(ValueError, match="variant"):
        rx.ablated_stage_b(tr, tr, nfft=nfft, variant="noswap")
    with pytest.raises(ValueError, match="planes"):
        rx.ablated_stage_b(torch.zeros((2, 32, 128)), torch.zeros((2, 32, 128)),
                           nfft=nfft, variant="full")
    with pytest.raises(ValueError, match="planes"):
        rx.ablated_stage_b(tr, torch.zeros((2, 64, 32)), nfft=nfft, variant="full")
    with pytest.raises(ValueError, match="planes"):
        rx.ablated_stage_b(tr.double(), tr.double(), nfft=nfft, variant="full")
    with pytest.raises(ValueError, match="planes"):
        rx.ablated_stage_b(torch.zeros((2, nfft)), torch.zeros((2, nfft)), nfft=nfft,
                           variant="full")
    big = 1 << 24       # R1 = 4096: no variant is built for it
    with pytest.raises(ValueError, match="2\\^23"):
        rx.ablated_stage_b(torch.zeros((1, 4096, 4096)), torch.zeros((1, 4096, 4096)),
                           nfft=big, variant="full")
    with pytest.raises(ValueError, match="variant"):
        fc._ablated_column(torch.zeros(64, dtype=torch.complex64), -1, "dotsonly")


def test_bound_and_variants():
    """The variants in the kernel's id order, and the byte bound at both
    measured shapes: 16 bytes a point and row, 0.3205 ms at 3.35 TB/s."""
    assert rx.VARIANTS == ("full", "notwiddle", "noexchange", "butterflies", "memcopy")
    assert [fc.ABLATIONS[v] for v in rx.VARIANTS] == [0, 1, 2, 3, 4]
    for nfft, S in ((1 << 20, 64), (1 << 22, 16)):
        assert rx.bound_ms(nfft, S) == pytest.approx(0.32052, abs=1e-5)


def test_without_a_card_run_and_script_exit_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time it")
    with pytest.raises(RuntimeError, match="is_available"):
        rx.run(nfft=1 << 12, scales=2)
    with pytest.raises(ValueError, match="tier"):
        rx.run(tier="medium")
    proc = subprocess.run(
        [sys.executable, "-m", "pycwt_torch.tools.relayout_experiment", "fast",
         "--nfft", "4096", "--scales", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CPU timing" in proc.stderr
