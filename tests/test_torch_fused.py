"""The port's fused CWT (ops/fused_cwt.py) on the CPU, in float32, against
pycwt_tpu's Pallas kernels run in interpret mode: at nfft 2^14 JAX runs its
two-kernel path (kernels A and B), at 2^12 its planar small path.  Also the
kernel layout's plain versions, the CUDA kernels' column radix plan, tiles
and Stockham passes (mirrored in PyTorch), the library build's hash, the
errors, and the whole cwt_power slice."""
import math
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.config import CWTConfig as JConfig
from pycwt_tpu.ops import mxu_dft as jdft
from pycwt_tpu.ops import pallas_fft as jpf
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mxu_dft as tdft

torch.set_num_threads(2)

MOTHERS = [(wt.Morlet(6), pt.Morlet(6)), (wt.Paul(4), pt.Paul(4)),
           (wt.DOG(2), pt.DOG(2)), (wt.DOG(6), pt.DOG(6))]
MIDS = ["Morlet6", "Paul4", "DOG2", "DOG6"]
SPECTRA = [(j, t, half) for (j, t) in MOTHERS for half in (False, True)
           if not half or j.analytic_negligible_negative()]
SIDS = [f"{m}-{'half' if h else 'full'}" for m, (j, t) in zip(MIDS, MOTHERS)
        for h in (False, True) if not h or j.analytic_negligible_negative()]
SCALES = 2.0 * 2 ** (np.arange(6) * 1.5)


def _spectrum(nfft, half, seed=0):
    x = np.random.default_rng(seed).standard_normal(nfft).astype(np.float32)
    sr, si = jdft.fft_of_real_planar(jnp.asarray(x), nfft, half=half)
    return np.asarray(sr), np.asarray(si)


@pytest.mark.parametrize("output", ["planes", "power", "power_sum"])
@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
@pytest.mark.parametrize("nfft", [1 << 12, 1 << 14], ids=["2^12", "2^14"])
def test_fused_cwt_planar_matches_jax_kernels(nfft, spec, output):
    j, t, half = SPECTRA[spec]
    sr, si = _spectrum(nfft, half)
    kw = dict(nfft=nfft, dt=1.0, output=output)
    ref = jpf.fused_cwt_planar(jnp.asarray(sr), jnp.asarray(si),
                               jnp.asarray(SCALES, jnp.float32), mother=j,
                               interpret=True, Ablk=32, Cblk=32,
                               precision="highest", **kw)
    got = fc.fused_cwt_planar(torch.tensor(sr), torch.tensor(si),
                              torch.tensor(SCALES, dtype=torch.float32),
                              mother=t, **kw)
    if output == "planes":
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
        got = got[0].numpy() + 1j * got[1].numpy()
    else:
        ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape and got.dtype.itemsize in (4, 8)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("pow2", [8, 9, 13, 14])
@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_kernel_layout_plain_versions_equal_plain_transform(spec, pow2):
    """Stage A then stage B in the kernels' layout (T as (rows, R1, R2), the
    analytic row cut, the a·c twiddle, the time-major output) equals the
    bank × X then ifft, at f64 round-off, for odd and even splits."""
    _, t, half = SPECTRA[spec]
    # Morlet-6 on a full spectrum: the kernel layout drops the negative
    # frequencies as K1 does, where its envelope is below exp(-18) = 1.5e-8.
    bound = 3e-8 if isinstance(t, pt.Morlet) and not half else 1e-13
    nfft = 1 << pow2
    x = torch.tensor(np.random.default_rng(pow2).standard_normal((2, nfft)))
    sr, si = tdft.fft_of_real_planar(x, nfft, half=half)
    scales = torch.tensor(SCALES[:4])
    T = fc.stage_a(sr, si, scales, mother=t, nfft=nfft, dt=0.5)
    R1, R2 = fc._nfft_factors(nfft)
    assert T[0].shape == (8, R1, R2)
    for output in ("planes", "power", "power_sum"):
        ref = fc._fused_cwt_planar_reference(sr, si, scales, mother=t,
                                             nfft=nfft, dt=0.5, output=output)
        got = fc.stage_b(*T, nfft=nfft, output=output)
        if output == "planes":
            got = torch.complex(*got).reshape(2, 4, nfft)
            ref = torch.complex(*ref)
        got = got.reshape(ref.shape)
        assert float((got - ref).abs().max()) <= bound * float(ref.abs().max())
    assert fc.KERNEL_LAUNCHES == {"cwt_stage_a": 0, "cwt_stage_b": 0, "cwt_direct": 0,
                                  "cwt_stage_a_bf16": 0, "cwt_stage_b_bf16": 0}


def test_supported_nfft_matches_jax():
    for n in [1000] + [1 << p for p in range(7, 21)]:
        assert fc.supported_nfft(n) == jpf.supported_nfft(n), n
    for n in [1 << p for p in range(8, 21)]:
        assert fc._nfft_factors(n) == jpf._nfft_factors(n)


def test_tile_sizes_fit_hopper_shared_memory():
    """cols·R ≤ 8192 points (512 threads of 16 points), and ≥ 128 threads
    wherever the other factor has enough columns; two blocks fit on one SM
    wherever a block has 512 threads."""
    for p in range(8, 27):
        R1, R2 = fc._nfft_factors(1 << p)
        for R, other in ((R2, R1), (R1, R2)):
            cols = fc._tile_cols(R, other)
            assert cols & (cols - 1) == 0 and other % cols == 0
            assert fc._smem_bytes(R, cols) <= fc._SMEM_MAX
            threads = cols * R // 16
            assert threads <= 512 and (threads >= 128 or cols == other)
            if threads == 512:
                assert 2 * fc._smem_bytes(R, cols) <= fc._SMEM_MAX
    assert fc._tile_cols(1024, 1024) == 8
    with pytest.raises(ValueError):
        fc._tile_cols(1 << 14, 1 << 14)


@pytest.mark.parametrize("log_r", range(4, 14))
def test_column_radix_plan(log_r):
    """Radix-16 passes and a last radix of 2..16, as ColumnPlan in
    csrc/fft_common.cuh: 16, 16·2..16·16, 16·16·2..16·16·16, 16·16·16·2."""
    R = 1 << log_r
    plan = fc._column_radix_plan(R)
    assert math.prod(plan) == R and len(plan) == (log_r + 3) // 4
    assert all(r == 16 for r in plan[:-1]) and plan[-1] in (2, 4, 8, 16)
    assert fc._plan_args(R) == plan + (1,) * (4 - len(plan))
    for bad in (R // 2 if R == 16 else R + 16, 2 * R if R == 8192 else 3 * R):
        with pytest.raises(ValueError):
            fc._column_radix_plan(bad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("log_r", range(4, 14))
def test_column_stockham_matches_ifft(log_r, dtype):
    """The kernels' column FFT mirrored in PyTorch against torch.fft.ifft
    (unnormalised) along a middle axis: f64 within 1e-12 and f32 within 2e-6
    of max|·|."""
    R = 1 << log_r
    rng = np.random.default_rng(log_r)
    x = torch.tensor(rng.standard_normal((2, R, 3)) + 1j * rng.standard_normal((2, R, 3)))
    ref = torch.fft.ifft(x, dim=1, norm="forward")
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    got = fc._column_stockham(x.to(cdtype), 1)
    assert got.shape == x.shape and got.dtype == cdtype
    bound = 1e-12 if dtype == torch.float64 else 2e-6
    assert float((got.to(ref.dtype) - ref).abs().max()) <= bound * float(ref.abs().max())


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
@pytest.mark.parametrize("pow2", [9, 13, 14])
def test_stage_references_on_column_mirror(spec, pow2):
    """Stage A and stage B rebuilt on the kernels' column passes equal their
    torch.fft references at f64 round-off (1e-12), for odd (2^9, 2^13) and
    even (2^14) splits: T, and W in every output."""
    _, t, half = SPECTRA[spec]
    nfft = 1 << pow2
    x = torch.tensor(np.random.default_rng(pow2).standard_normal((2, nfft)))
    sr, si = tdft.fft_of_real_planar(x, nfft, half=half)
    kw = dict(mother=t, nfft=nfft, dt=0.5)
    scales = torch.tensor(SCALES[:4])
    T = fc._stage_a_reference(sr, si, scales, **kw)
    Tm = fc._stage_a_reference(sr, si, scales, column_fft=fc._column_stockham, **kw)
    T_max = float(torch.complex(*T).abs().max())
    assert float((torch.complex(*Tm) - torch.complex(*T)).abs().max()) <= 1e-12 * T_max
    for output in ("planes", "power", "power_sum"):
        ref = fc._stage_b_reference(*T, nfft=nfft, output=output)
        got = fc._stage_b_reference(*T, nfft=nfft, output=output,
                                    column_fft=fc._column_stockham)
        if output == "planes":
            got, ref = torch.complex(*got), torch.complex(*ref)
        assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max()), output


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_column_mirror_pair_matches_jax_kernels(spec):
    """At nfft 2^14, in float32: stage A then stage B on the kernels'
    column passes against pycwt_tpu's kernels A and B in interpret mode,
    within 1e-5 of max|W| (planes and the Σ_t |W|² epilogue)."""
    j, t, half = SPECTRA[spec]
    nfft = 1 << 14
    sr, si = _spectrum(nfft, half)
    S = len(SCALES)
    kw = dict(nfft=nfft, dt=1.0)
    T = fc._stage_a_reference(torch.tensor(sr)[None], torch.tensor(si)[None],
                              torch.tensor(SCALES, dtype=torch.float32), mother=t,
                              column_fft=fc._column_stockham, **kw)
    assert T[0].dtype == torch.float32
    for output in ("planes", "power_sum"):
        ref = jpf.fused_cwt_planar(jnp.asarray(sr), jnp.asarray(si),
                                   jnp.asarray(SCALES, jnp.float32), mother=j,
                                   interpret=True, Ablk=32, Cblk=32,
                                   precision="highest", output=output, **kw)
        got = fc._stage_b_reference(*T, nfft=nfft, output=output,
                                    column_fft=fc._column_stockham)
        if output == "planes":
            ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
            got = (got[0].numpy() + 1j * got[1].numpy()).reshape(S, nfft)
        else:
            ref, got = np.asarray(ref), got.numpy()
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), output


def _pad(p):
    return p + (p >> 4)


def _banks_distinct(slots):
    """Each half-warp's distinct 8-byte slots fall on distinct bank pairs."""
    for h in range(0, len(slots), 16):
        u = np.unique(slots[h:h + 16])
        assert len(np.unique(u % 16)) == len(u), slots[h:h + 16]


@pytest.mark.parametrize("log_r", range(4, 14))
def test_column_layout_keeps_shared_accesses_off_shared_banks(log_r):
    """The column stride of _column_ld and the kernels' two thread maps
    (csrc/fused_cwt.cu): the first pass's stores and cwt_stage_b's last-pass
    loads, which cross columns (threads column-fastest), hit distinct banks
    at every R and tile; from R = 256 on, the passes with threads
    point-fastest do too.  The first pass's stores fill every slot of each
    column once."""
    R = 1 << log_r
    TC = R // 16
    plan = fc._column_radix_plan(R)
    for other in sorted({16, R, 1 << 13}):
        cols = fc._tile_cols(R, min(other, 1 << 13))
        ld = fc._column_ld(R, cols)
        t = np.arange(cols * TC)
        by_col = (t % cols, t // cols)      # column-fastest: (column, lt)
        by_pt = (t // TC, t % TC)           # point-fastest
        slots = [by_col[0] * ld + _pad(16 * by_col[1] + r) for r in range(16)]
        for sl in slots:
            _banks_distinct(sl)
        assert np.array_equal(np.sort(np.concatenate(slots)), np.sort(
            (np.arange(cols)[:, None] * ld + _pad(np.arange(R))[None]).ravel()))
        RL, NS = plan[-1], R // plan[-1]
        maps = [by_col] + ([by_pt] if R >= 256 else [])
        for j, lt in maps:      # the last pass's loads
            for q in range(16 // RL):
                for r in range(RL):
                    _banks_distinct(j * ld + _pad(lt + q * TC + r * NS))
        if R >= 256:            # the radix-16 passes in between
            j, lt = by_pt
            for Ns in (16, 256)[:len(plan) - 2]:
                d = (lt // Ns) * Ns * 16 + lt % Ns
                for r in range(16):
                    _banks_distinct(j * ld + _pad(lt + r * TC))
                    _banks_distinct(j * ld + _pad(d + r * Ns))


def test_build_target_hashes_headers(tmp_path):
    """An edited shared header (csrc/*.cuh) renames both libraries' targets,
    so neither loads a stale build; unchanged files keep the name."""
    from pycwt_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    before = {name: _build._target(name, str(csrc)) for name in _build.SOURCES}
    assert before == {name: _build._target(name) for name in _build.SOURCES}
    headers[0].write_bytes(headers[0].read_bytes() + b"\n")
    after = {name: _build._target(name, str(csrc)) for name in _build.SOURCES}
    assert all(after[name] != before[name] for name in _build.SOURCES)
    assert _build._target("fused_cwt", str(csrc)) == after["fused_cwt"]


@pytest.mark.parametrize("half", [False, True], ids=["full", "half"])
@pytest.mark.parametrize("nfft", [256, 1 << 12])
def test_fft_of_real_planar_matches_jax(nfft, half):
    x = np.random.default_rng(1).standard_normal((2, nfft)).astype(np.float32)
    jr, ji = jdft.fft_of_real_planar(jnp.asarray(x), nfft, half=half)
    tr, ti = tdft.fft_of_real_planar(torch.tensor(x), nfft, half=half)
    scale = float(np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=0, atol=1e-5 * scale)
    xd = torch.tensor(x, dtype=torch.float64)
    np.testing.assert_allclose(torch.complex(*tdft.fft_of_real_planar(xd, 2 * nfft)).numpy(),
                               np.fft.fft(x.astype(np.float64), 2 * nfft), atol=1e-10)
    np.testing.assert_allclose(tdft.dft(xd, nfft, sign=1).numpy(),
                               np.fft.ifft(x, nfft) * nfft, atol=1e-9)
    np.testing.assert_allclose(tdft.idft(tdft.fft_of_real(xd, nfft)).real.numpy(),
                               x, atol=1e-6)
    with pytest.raises(ValueError):
        tdft.fft_of_real_planar(xd, 1000)


def test_fused_cwt_errors():
    sr, si = (torch.zeros(1024),) * 2
    hr, hi = (torch.zeros(512),) * 2
    sc = torch.ones(2)
    kw = dict(nfft=1024, dt=1.0)
    with pytest.raises(ValueError, match="conflicting"):
        fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), power_only=True,
                            output="power", **kw)
    with pytest.raises(ValueError, match="output"):
        fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), output="map", **kw)
    with pytest.raises(ValueError, match="precision"):
        fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), precision="x", **kw)
    with pytest.raises(ValueError, match="analytic"):
        fc.fused_cwt_planar(hr, hi, sc, mother=pt.DOG(2), **kw)
    with pytest.raises(ValueError, match="incompatible"):
        fc.fused_cwt_planar(sr[:700], si[:700], sc, mother=pt.Morlet(6), **kw)
    for bad in (1000, 128):
        with pytest.raises(ValueError, match="nfft"):
            fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), nfft=bad, dt=1.0)
    with pytest.raises(RuntimeError, match="cpu"):
        fc.fused_cwt_planar(sr.to("meta"), si.to("meta"), sc.to("meta"),
                            mother=pt.Morlet(6), **kw)
    p = fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), power_only=True, **kw)
    assert p.shape == (2,)
    # small_kernel only changes the CUDA path; on the CPU the plain version runs
    w = fc.fused_cwt_planar(sr, si, sc, mother=pt.Morlet(6), small_kernel=True, **kw)
    assert w[0].shape == (2, 1024)


def test_fused_cwt_complex_wrapper_and_batch():
    nfft = 1024
    x = torch.tensor(np.random.default_rng(4).standard_normal((3, nfft)),
                     dtype=torch.float32)
    X = torch.fft.fft(x)
    sc = torch.tensor(SCALES[:3], dtype=torch.float32)
    W = fc.fused_cwt(X, sc, mother=pt.Paul(4), nfft=nfft, dt=1.0)
    assert W.shape == (3, 3, nfft) and W.dtype == torch.complex64
    wr, wi = fc.fused_cwt_planar(X.real, X.imag, sc, mother=pt.Paul(4),
                                 nfft=nfft, dt=1.0)
    torch.testing.assert_close(W, torch.complex(wr, wi), rtol=0, atol=0)
    p = fc.fused_cwt(X[0], sc, mother=pt.Paul(4), nfft=nfft, dt=1.0,
                     power_only=True)
    torch.testing.assert_close(p, (W[0].abs() ** 2).sum(-1), rtol=1e-5, atol=0)


def test_autograd_function_replays_plain_version():
    """On CPU tensors the autograd Function's forward runs the kernels'
    plain versions (stage A, stage B) and its backward the plain transform:
    gradients match JAX's through its fused path's XLA formulation."""
    nfft = 1 << 12
    x0 = np.random.default_rng(3).standard_normal(nfft).astype(np.float32)
    sc0 = np.array([4.0, 16.0, 64.0], np.float32)
    m = pt.Morlet(6)

    def loss(fn, x, sc):
        sr, si = tdft.fft_of_real_planar(x, nfft)
        return fn(sr, si, sc).sum() / nfft

    def via_function(sr, si, sc):
        return fc._FusedCWT.apply(sr[None], si[None], sc, m, nfft, 1.0,
                                  "power_sum")

    def via_plain(sr, si, sc):
        return fc._fused_cwt_planar_reference(sr, si, sc, mother=m, nfft=nfft,
                                              dt=1.0, output="power_sum")

    grads = []
    for fn in (via_function, via_plain):
        x = torch.tensor(x0, requires_grad=True)
        sc = torch.tensor(sc0, requires_grad=True)
        grads.append(torch.autograd.grad(loss(fn, x, sc), (x, sc)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))

    def jloss(x, sc):
        sr, si = jdft.fft_of_real_planar(x, nfft)
        wr, wi = jpf._small_planar_xla(sr, si, sc, mother=wt.Morlet(6), nfft=nfft,
                                       dt=1.0, precision=jax.lax.Precision.HIGHEST)
        return (wr * wr + wi * wi).sum() / nfft

    gx, gs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x0), jnp.asarray(sc0))
    np.testing.assert_allclose(grads[0][0].numpy(), np.asarray(gx), rtol=0,
                               atol=1e-4 * float(jnp.abs(gx).max()))
    np.testing.assert_allclose(grads[0][1].numpy(), np.asarray(gs), rtol=1e-4)
    # planes: a gradient through one plane only, to one input only
    sr = torch.tensor(x0[None], requires_grad=True)
    wr, wi = fc._FusedCWT.apply(sr, torch.zeros(1, nfft), torch.tensor(sc0),
                                m, nfft, 1.0, "planes")
    (g,) = torch.autograd.grad(wr.sum(), sr)
    sr_ref = torch.tensor(x0[None], requires_grad=True)
    wr_ref, _ = fc._fused_cwt_planar_reference(sr_ref, torch.zeros(1, nfft),
                                               torch.tensor(sc0), mother=m,
                                               nfft=nfft, dt=1.0)
    (g_ref,) = torch.autograd.grad(wr_ref.sum(), sr_ref)
    torch.testing.assert_close(g, g_ref, rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["highest", "fast"])
@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_complex_epilogue_equals_assembled_planes(spec, precision):
    """The ``complex`` epilogue is the planes assembled by ``torch.complex``,
    bit for bit: stage B's plain version on an f32 and a bf16 T, and
    ``fused_cwt_planar`` on the CPU route of each tier (the plain transform
    at ``highest``, the two stages' plain versions through ``_FusedCWT`` at
    ``fast``)."""
    _, t, half = SPECTRA[spec]
    nfft = 1 << 12
    sr, si = (torch.tensor(a) for a in _spectrum(nfft, half, seed=spec))
    sc = torch.tensor(SCALES[:4], dtype=torch.float32)
    kw = dict(mother=t, nfft=nfft, dt=0.5)
    T = fc._stage_a_reference(sr[None], si[None], sc, t_dtype=fc._t_dtype(precision), **kw)
    got = fc._stage_b_reference(*T, nfft=nfft, output="complex")
    want = torch.complex(*fc._stage_b_reference(*T, nfft=nfft, output="planes"))
    assert got.dtype == torch.complex64 and torch.equal(got, want)
    got = fc.fused_cwt_planar(sr, si, sc, output="complex", precision=precision, **kw)
    want = torch.complex(
        *fc.fused_cwt_planar(sr, si, sc, output="planes", precision=precision, **kw))
    assert got.shape == (4, nfft) and got.dtype == torch.complex64
    assert torch.equal(got, want)


@pytest.mark.parametrize("small_kernel", [False, True], ids=["default", "small_kernel"])
@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_fused_cwt_returns_the_complex_epilogue(spec, small_kernel):
    """``fused_cwt`` takes the ``complex`` epilogue: its W is the planes'
    ``torch.complex``, bit for bit, on the default route and on the
    ``small_kernel`` route (K3's plain version, whose planes are assembled)."""
    _, t, half = SPECTRA[spec]
    nfft = 1 << 12
    sr, si = (torch.tensor(np.stack(a)) for a in zip(
        _spectrum(nfft, half, seed=spec), _spectrum(nfft, half, seed=spec + 9)))
    sc = torch.tensor(SCALES[:3], dtype=torch.float32)
    kw = dict(mother=t, nfft=nfft, dt=1.0, small_kernel=small_kernel)
    W = fc.fused_cwt(torch.complex(sr, si), sc, **kw)
    want = torch.complex(*fc.fused_cwt_planar(sr, si, sc, output="planes", **kw))
    assert W.shape == (2, 3, nfft) and W.dtype == torch.complex64
    assert torch.equal(W, want)
    assert torch.equal(fc.fused_cwt_planar(sr, si, sc, output="complex", **kw), want)


@pytest.mark.parametrize("spec", range(len(SPECTRA)), ids=SIDS)
def test_complex_epilogue_gradient_equals_planes_gradient(spec):
    """At ``precision="fast"`` a CPU tensor runs ``_FusedCWT``, whose
    backward replays the f32 plain version in the epilogue asked for: the
    gradient of a real loss of the complex output equals that of the same
    loss taken through the planes, for the spectrum and the scales."""
    _, t, half = SPECTRA[spec]
    nfft = 1 << 12
    sr0, si0 = (torch.tensor(a) for a in _spectrum(nfft, half, seed=spec))
    sc0 = torch.tensor(SCALES[:3], dtype=torch.float32)
    rng = np.random.default_rng(spec)
    a, b = (torch.tensor(rng.standard_normal((3, nfft)), dtype=torch.float32)
            for _ in range(2))
    kw = dict(mother=t, nfft=nfft, dt=1.0, precision="fast")

    def grads(output):
        sr, si, sc = (v.clone().requires_grad_() for v in (sr0, si0, sc0))
        out = fc.fused_cwt_planar(sr, si, sc, output=output, **kw)
        wr, wi = (out.real, out.imag) if output == "complex" else out
        loss = (a * wr + b * wi).sum() + (wr * wr + wi * wi).sum() / nfft
        return torch.autograd.grad(loss, (sr, si, sc))

    for got, want in zip(grads("complex"), grads("planes")):
        assert bool(want.abs().max() > 0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n0", [3000, 10000], ids=["nfft4096", "nfft16384"])
def test_cwt_power_slice_matches_jax(n0):
    """The whole slice: host grid, forward DFT, fused CWT with the |W|²
    epilogue, trim — port (plain versions on the CPU) against pycwt_tpu's
    planar engine (interpret-mode kernels at 2^14), both at 'highest'."""
    x = np.random.default_rng(n0).standard_normal(n0)
    pj, sj_j, fj, coi_j = wt.cwt_power(
        x, 0.5, dj=1, config=JConfig(engine="planar", precision="highest"))
    pt_, sj_t, ft, coi_t = pt.cwt_power(
        x, 0.5, dj=1, config=CWTConfig(engine="planar", precision="highest"),
        device="cpu")
    np.testing.assert_array_equal(sj_t, sj_j)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(coi_t, coi_j)
    pj = np.asarray(pj)
    assert pt_.shape == pj.shape == (len(sj_j), n0)
    assert np.abs(pt_ - pj).max() <= 2e-5 * pj.max()
