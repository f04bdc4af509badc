"""The ``fast`` tier's bf16 intermediate T on the CPU: the port's plain
version of ``cwt_stage_a_bf16`` → ``cwt_stage_b_bf16`` against pycwt_tpu's
bf16-T kernels A and B in interpret mode at nfft 2^14 (the smallest nfft
where pycwt_tpu runs its two kernels, and so a bf16 T), the rounding of T,
the tiers' routes through the public entry points, the gradient, the T
types each stage takes, and cwt_stage_b's blocks (csrc/fused_cwt.cu): their
columns and shared memory, the staged tile of ``cwt_stage_b_bf16`` and the
f32 wide block's thread map mirrored in numpy, and the count of wide
launches."""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu.ops import mxu_dft as jdft
from pycwt_tpu.ops import pallas_fft as jpf
from pycwt_torch import transform as ttr
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mxu_dft as tdft

torch.set_num_threads(2)

NFFT = 1 << 14
#: the fast tier's bound relative to max|W| (tests/test_pallas.py:276)
FAST_BOUND = 2e-2
SPECTRA = {"Morlet6-full": (wt.Morlet(6), pt.Morlet(6), False),
           "Morlet6-half": (wt.Morlet(6), pt.Morlet(6), True),
           "DOG2-full": (wt.DOG(2), pt.DOG(2), False)}
OUTPUTS = ("planes", "power", "power_sum")
SCALES = np.float32(2.0 * 2 ** (np.arange(5) * 1.5))


def _spectrum(half, seed=14):
    x = np.random.default_rng(seed).standard_normal(NFFT).astype(np.float32)
    sr, si = jdft.fft_of_real_planar(jnp.asarray(x), NFFT, half=half)
    return np.asarray(sr), np.asarray(si)


def _max_err(got, ref, output):
    """Max |got - ref| over max|ref| (max|W| for planes)."""
    if output == "planes":
        got, ref = got[0] + 1j * got[1], ref[0] + 1j * ref[1]
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _numpy(out):
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


@pytest.mark.parametrize("output", OUTPUTS)
@pytest.mark.parametrize("spec", list(SPECTRA))
def test_fast_plain_version_matches_pycwt_tpu_bf16_kernels(spec, output):
    """The port's ``fast`` plain version (stage A's plain version, T rounded
    to bf16, stage B's) against pycwt_tpu's kernels A and B with a bf16 T
    (``precision="fast"``, interpret mode), within the tier's 2e-2 of
    max|W|.  JAX's fast tier also rounds its DFT matmuls to bf16, so only
    the tier's bound applies."""
    jm, tm, half = SPECTRA[spec]
    sr, si = _spectrum(half)
    want = jpf.fused_cwt_planar(jnp.asarray(sr), jnp.asarray(si), jnp.asarray(SCALES),
                                mother=jm, nfft=NFFT, dt=1.0, precision="fast",
                                interpret=True, output=output)
    want = tuple(np.asarray(w) for w in want) if output == "planes" else np.asarray(want)
    got = fc.fused_cwt_planar(torch.tensor(sr), torch.tensor(si), torch.tensor(SCALES),
                              mother=tm, nfft=NFFT, dt=1.0, precision="fast",
                              output=output)
    err = _max_err(_numpy(got), want, output)
    print(f"{spec} {output}: port fast vs pycwt_tpu fast {err:.3e} of max")
    assert err < FAST_BOUND


def test_stage_a_reference_rounds_f32_T_once_to_nearest_even():
    """``_stage_a_reference(t_dtype=bf16)`` is its f32 T rounded once, bit
    for bit as ``astype(jnp.bfloat16)`` rounds it (nearest, ties to even);
    ``_stage_b_reference`` widens a bf16 T exactly to f32 first."""
    sr, si = (torch.tensor(p)[None] for p in _spectrum(True))
    kw = dict(mother=pt.Morlet(6), nfft=NFFT, dt=1.0)
    sc = torch.tensor(SCALES)
    T32 = fc._stage_a_reference(sr, si, sc, **kw)
    T16 = fc._stage_a_reference(sr, si, sc, t_dtype=torch.bfloat16, **kw)
    assert T32[0].dtype == torch.float32
    for p32, p16 in zip(T32, T16):
        assert p16.dtype == torch.bfloat16 and p16.shape == p32.shape
        assert torch.equal(p16, p32.to(torch.bfloat16))
        bits = np.asarray(jnp.asarray(p32.numpy()).astype(jnp.bfloat16)).view(np.uint16)
        assert np.array_equal(p16.view(torch.int16).numpy().view(np.uint16), bits)
        assert not torch.equal(p16.to(torch.float32), p32)   # it did round
    for output in OUTPUTS:
        a = fc._stage_b_reference(*T16, nfft=NFFT, output=output)
        b = fc._stage_b_reference(*(p.to(torch.float32) for p in T16), nfft=NFFT,
                                  output=output)
        for x, y in zip(*(o if isinstance(o, tuple) else (o,) for o in (a, b))):
            assert x.dtype == torch.float32 and torch.equal(x, y)


@pytest.mark.parametrize("output", OUTPUTS)
def test_plain_fast_differs_from_plain_high_within_the_tier(output):
    """On the CPU ``fast`` is the bf16-T composition and ``high`` the f32
    plain transform: they differ, and by less than 2e-2 of max|W|."""
    sr, si = (torch.tensor(p) for p in _spectrum(True))
    kw = dict(mother=pt.Morlet(6), nfft=NFFT, dt=1.0, output=output)
    sc = torch.tensor(SCALES)
    high = _numpy(fc.fused_cwt_planar(sr, si, sc, precision="high", **kw))
    fast = _numpy(fc.fused_cwt_planar(sr, si, sc, precision="fast", **kw))
    plain = _numpy(fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    for h, p in zip(*(o if isinstance(o, tuple) else (o,) for o in (high, plain))):
        assert np.array_equal(h, p)
    gap = _max_err(fast, high, output)
    print(f"{output}: plain fast vs plain high {gap:.3e} of max")
    assert 0.0 < gap < FAST_BOUND


#: entry point -> a call on a 600-point signal (nfft 1024) under ``config``
ENTRIES = {
    "api.cwt": lambda x, cfg: pt.cwt(x, 1.0, dj=0.5, config=cfg, device="cpu"),
    "api.cwt_power": lambda x, cfg: pt.cwt_power(x, 1.0, dj=0.5, config=cfg,
                                                 device="cpu"),
    "cwt_batch": lambda x, cfg: ttr.cwt_batch(
        torch.tensor(x[None]), torch.tensor([2.0, 8.0, 32.0]), 1.0,
        mother=pt.Morlet(6), nfft=1024, config=cfg),
    "_planar_cwt_of_real": lambda x, cfg: fc._planar_cwt_of_real(
        torch.tensor(x[None]), [2.0, 8.0, 32.0], mother=pt.Morlet(6), nfft=1024,
        dt=1.0, precision=cfg.precision),
}


@pytest.mark.parametrize("tier", ["fast", "high"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_config_precision_reaches_the_bf16_composition(monkeypatch, entry, tier):
    """A spy on the stage plain versions: ``CWTConfig(precision="fast")``
    reaches stage A with a bf16 T and stage B on it through each entry
    point; ``high`` reaches neither (it runs the f32 plain transform)."""
    seen = []
    stage_a_ref, stage_b_ref = fc._stage_a_reference, fc._stage_b_reference

    def spy_a(*args, t_dtype=None, **kw):
        seen.append(("A", t_dtype))
        return stage_a_ref(*args, t_dtype=t_dtype, **kw)

    def spy_b(tr, ti, **kw):
        seen.append(("B", tr.dtype))
        return stage_b_ref(tr, ti, **kw)

    monkeypatch.setattr(fc, "_stage_a_reference", spy_a)
    monkeypatch.setattr(fc, "_stage_b_reference", spy_b)
    cfg = CWTConfig(engine="planar", precision=tier, dtype=torch.float32)
    x = np.random.default_rng(7).standard_normal(600)
    ENTRIES[entry](x, cfg)
    if tier == "fast":
        assert seen == [("A", torch.bfloat16), ("B", torch.bfloat16)]
    else:
        assert seen == []


@pytest.mark.parametrize("output", OUTPUTS)
def test_fast_gradient_is_the_f32_plain_versions(output):
    """At ``fast`` the gradient through ``_FusedCWT`` (and so through
    ``fused_cwt_planar``, which takes it on the CPU at that tier) is the f32
    plain version's, bit for bit: the backward replays it."""
    nfft = 1 << 12
    x0 = np.random.default_rng(3).standard_normal(nfft).astype(np.float32)
    sc0 = np.float32([4.0, 16.0, 64.0])
    m = pt.Morlet(6)

    def grads(fn):
        x = torch.tensor(x0, requires_grad=True)
        sc = torch.tensor(sc0, requires_grad=True)
        sr, si = tdft.fft_of_real_planar(x, nfft)
        out = fn(sr, si, sc)
        loss = sum(o.sum() for o in out) if isinstance(out, tuple) else out.sum()
        return torch.autograd.grad(loss / nfft, (x, sc))

    kw = dict(mother=m, nfft=nfft, dt=1.0, output=output)
    via_fn = grads(lambda sr, si, sc: fc._FusedCWT.apply(
        sr[None], si[None], sc, m, nfft, 1.0, output, "fast"))
    via_api = grads(lambda sr, si, sc: fc.fused_cwt_planar(sr, si, sc, precision="fast",
                                                           **kw))
    plain = grads(lambda sr, si, sc: fc._fused_cwt_planar_reference(sr, si, sc, **kw))
    for a, b, c in zip(via_fn, via_api, plain):
        assert torch.isfinite(c).all()
        assert torch.equal(a, c) and torch.equal(b, c)


def test_stages_refuse_other_T_types():
    """stage_a makes an f32 or a bf16 T and nothing else; stage_b takes two
    f32 or two bf16 planes (and, on the CPU, the f64 T that stage_a gives
    for f64 inputs there)."""
    nfft = 1 << 10
    R1, R2 = fc._nfft_factors(nfft)
    sr, si = tdft.fft_of_real_planar(torch.ones(nfft), nfft)
    kw = dict(mother=pt.Morlet(6), nfft=nfft, dt=1.0)
    for bad in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fc.stage_a(sr[None], si[None], torch.tensor([2.0]), t_dtype=bad, **kw)
    T = torch.zeros((1, R1, R2))
    for tr, ti in ((T.half(), T.half()), (T.int(), T.int()), (T, T.bfloat16()),
                   (T.bfloat16(), T)):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fc.stage_b(tr, ti, nfft=nfft, output="power")
    assert fc.stage_b(T.double(), T.double(), nfft=nfft, output="power").dtype == \
        torch.float64
    for t_dtype in fc._T_DTYPES:
        tr, ti = fc.stage_a(sr[None], si[None], torch.tensor([2.0]), t_dtype=t_dtype, **kw)
        assert tr.dtype == ti.dtype == t_dtype and tr.shape == (1, R1, R2)
        assert fc.stage_b(tr, ti, nfft=nfft, output="power").dtype == torch.float32


@pytest.mark.parametrize("pow2", [8, 14, 18, 20, 21, 22, 23, 24, 26])
def test_stage_b_columns_and_shared_memory(pow2):
    """cwt_stage_b's wide blocks, 1024 threads over twice _tile_cols'
    columns: both T types at R1 = 2048 (8 columns; an f32 T's rows 32 bytes,
    read straight; a bf16 T's staged by a pair: 16 columns, 32 bytes a row,
    half of the rows in each block's shared memory after its FFT buffer),
    and a bf16 T at R1 = 1024 (16 columns, rows of T 32 bytes); each fits in
    227 KB, one block an SM.  Elsewhere the 512-thread tile holds: 32 bytes a
    row or more up to R1 = 1024 for an f32 T and below it for a bf16 T."""
    nfft = 1 << pow2
    R1, R2 = fc._nfft_factors(nfft)
    cols = fc._tile_cols(R1, R2)
    for t_dtype, size, wide_r1 in ((torch.float32, 4, (2048,)),
                                   (torch.bfloat16, 2, (1024, 2048))):
        got = fc._stage_b_cols(R1, R2, t_dtype)
        smem = fc._stage_b_smem_bytes(R1, got, t_dtype)
        assert fc._stage_b_wide(R1, t_dtype) == (R1 in wide_r1)
        if R1 in wide_r1:
            pair = t_dtype == torch.bfloat16 and R1 == 2048
            assert got == 2 * cols and got * R1 // 16 == 1024 and R2 % (2 * got) == 0
            # the FFT buffer and twiddles; a pair's 64 KB half-tile after it
            assert smem == {1024: 142080, 2048: 142208}[R1] + (65536 if pair else 0)
            assert smem % 16 == 0 and smem <= fc._SMEM_MAX < 2 * smem
            assert size * (2 * got if pair else got) == 32
        else:
            assert got == cols and smem == fc._smem_bytes(R1, cols) <= fc._SMEM_MAX
            assert size * cols >= 32 or R1 > 2048


@pytest.mark.parametrize("pow2", [22, 23])
def test_f32_wide_block_mirror(pow2):
    """cwt_stage_b's f32 wide block at R1 = 2048 (the first pass's loads and
    the epilogue's stores in csrc/fused_cwt.cu, the thread map of
    ops/fused_cwt._thread_map), mirrored in numpy: thread (j, lt) of a block
    loads T[a, c0 + j] for a = lt + r·R1/16, each element of the block's
    columns exactly once; the W stores along t land every output of those
    columns exactly once; and each warp's loads of one r, and its stores of
    one output slot, cover whole 32-byte rows (sectors), 4 of them."""
    R1, R2 = fc._nfft_factors(1 << pow2)
    cols = fc._stage_b_cols(R1, R2, torch.float32)
    threads = cols * R1 // 16
    assert threads == 1024
    src, dst = (m.numpy() for m in fc._thread_map(R1, "cpu"))   # (R1/16, 16)
    tid = np.arange(threads)
    j, lt = tid % cols, tid // cols
    c0 = 7 * cols                                              # a block's first column
    loaded = np.zeros((R1, R2), np.int64)
    stored = np.zeros(R1 * R2, np.int64)
    for k in range(16):
        a = src[lt, k]
        t = c0 + j + R2 * dst[lt, k]                           # W[row, t]
        np.add.at(loaded, (a, c0 + j), 1)
        np.add.at(stored, t, 1)
        for offsets in (a * R2 + c0 + j, t):                   # f32 elements of a row
            for w in range(0, threads, 32):
                byte = 4 * offsets[w:w + 32]
                sectors, words = np.unique(byte // 32, return_counts=True)
                assert len(np.unique(byte)) == 32 and len(sectors) == 4
                assert (words == 8).all()
    assert (loaded[:, c0:c0 + cols] == 1).all() and loaded.sum() == R1 * cols
    outputs = (c0 + np.arange(cols))[None, :] + R2 * np.arange(R1)[:, None]
    assert (stored[outputs] == 1).all() and stored.sum() == R1 * cols


@pytest.mark.parametrize("pow2,t_dtype,counted", [
    (22, torch.float32, True), (23, torch.float32, True), (20, torch.float32, False),
    (14, torch.float32, False), (22, torch.bfloat16, False)])
def test_stage_b_wide_launch_counter(monkeypatch, pow2, t_dtype, counted):
    """STAGE_B_WIDE_LAUNCHES counts the f32 cwt_stage_b launches that ran
    the wide block (R1 = 2048: nfft 2^22 and 2^23), not those at other R1
    nor cwt_stage_b_bf16's; the kernel gets _stage_b_cols' columns and
    power_sum's partials that many columns apiece.  A stand-in for the
    compiled library takes the launch: the kernels need a card."""
    from pycwt_torch.ops import _build

    launched = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: launched.append((name, args)) or 0

    monkeypatch.setattr(_build, "library", lambda name: Library())
    monkeypatch.setattr(fc, "_check_device", lambda t: "cuda")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(fc, "STAGE_B_WIDE_LAUNCHES", 0)
    monkeypatch.setattr(fc, "KERNEL_LAUNCHES", dict.fromkeys(fc.KERNEL_LAUNCHES, 0))
    nfft = 1 << pow2
    R1, R2 = fc._nfft_factors(nfft)
    T = torch.zeros((2, R1, R2), dtype=t_dtype)
    fc.stage_b(T, T, nfft=nfft, output="power_sum")
    name = "cwt_stage_b_bf16" if t_dtype == torch.bfloat16 else "cwt_stage_b"
    [(called, args)] = launched
    cols = args[7]
    assert called == name and fc.KERNEL_LAUNCHES[name] == 1
    assert fc.STAGE_B_WIDE_LAUNCHES == int(counted)
    assert cols == fc._stage_b_cols(R1, R2, t_dtype)
    assert cols == (2 if fc._stage_b_wide(R1, t_dtype) else 1) * fc._tile_cols(R1, R2)
    assert args[:7] == (T.data_ptr(), T.data_ptr(), args[2], args[3], 2, R1, R2)


def test_pair_staging_mirror():
    """cwt_stage_b_bf16's pair at R1 = 2048 (load_pair in
    csrc/fused_cwt.cu), mirrored in numpy: the two blocks' copies (16-byte
    pieces, two a 32-byte row, by neighbouring threads) land every element
    of the group's 16 columns in one of the two halves exactly once; block
    `rank`'s thread (j, lt) reads T[a, c0 + j] for a = lt + r·R1/16 from
    half r // 8, and a warp's reads of a half touch each 4-byte word of
    shared memory from one bank at most (no bank conflict)."""
    R1, R2 = 2048, 4096
    cols = fc._stage_b_cols(R1, R2, torch.bfloat16)
    H, TC, threads = R1 // 2, R1 // 16, 1024
    rng = np.random.default_rng(R1)
    T = rng.standard_normal((2, R1, R2)).astype(np.float32)     # (plane, a, c)
    group = 5 * 2 * cols                                         # the pair's first column
    halves = np.full((2, 2 * H * 16), np.nan, np.float32)
    for rank in range(2):
        first_byte = []
        for e in range(2 * H * 2):
            part, pa = e & 1, e >> 1
            plane, a = divmod(pa, H)
            a += rank * H
            dst = halves[rank, pa * 16 + part * 8: pa * 16 + part * 8 + 8]
            assert np.isnan(dst).all()
            dst[:] = T[plane, a, group + part * 8: group + part * 8 + 8]
            first_byte.append(2 * ((plane * R1 + a) * R2 + group + part * 8))
        seg = np.asarray(first_byte).reshape(-1, 2)
        assert (seg[:, 0] % 32 == 0).all() and (seg[:, 1] - seg[:, 0] == 16).all()
    assert not np.isnan(halves).any()
    tid = np.arange(threads)
    j, lt = tid & (cols - 1), tid // cols
    for rank in range(2):
        c0 = group + rank * cols
        for r in range(16):
            a = lt + r * TC
            assert ((a >= H) == (r >= 8)).all()
            h = halves[r // 8]
            for p in range(2):
                got = h[(p * H + (a & (H - 1))) * 16 + rank * cols + j]
                assert np.array_equal(got, T[p, a, c0 + j])
            words = ((a & (H - 1)) * 16 + rank * cols + j) // 2
            for w in range(0, threads, 32):
                ww = words[w:w + 32]
                for bank in np.unique(ww % 32):
                    assert len(np.unique(ww[ww % 32 == bank])) == 1
