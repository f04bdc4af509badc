"""The Monte-Carlo chunk's tail on the CPU (``coherence._mc_counts``,
``ops/mc_hist.py``, ``csrc/mc_hist.cu``): ``_planar_coherence`` split into
its fields and its ratio gives the old ``(WCT, phase, W12)`` bit for bit;
the chunk functions give the counts of ``_wct_core`` + ``_histogram`` on both
routes; the kernel's arithmetic, replayed in float32 numpy in its own
order, bins as ``_histogram`` of the torch ratio on fields with NaN, ±inf,
negative and zero denominators and R² on bin edges and above 1; the wrapper
through a stand-in for the CUDA library, which computes what the kernel
computes from the pointers it is given, against the torch path; the
wrapper's refusals; the point counters and the benchmark's reader of them,
``mc_hist_kernel_pct``.  The kernel itself runs on the card in
``test_torch_mc_hist_cuda.py``."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from cwtbench import harness
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.ops import mc_hist
from pycwt_torch.ops.smoothing import smooth_planar_pair
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

M6 = pt.Morlet(6)
#: a small Monte-Carlo grid (tests/test_torch_mc.py's SMALL): 8 scales
GRID = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the span recorder off and the
    counters at 0."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _grid():
    n, sj, oc, _, _ = tco._surrogate_grid(GRID["dt"], GRID["dj"], GRID["s0"],
                                          GRID["J"], M6)
    return n, torch.tensor(sj, dtype=torch.float32), torch.tensor(oc)


def _old_planar_coherence(w1, w2, scales, *, dt, dj, mother):
    """``_planar_coherence`` as it was before its split."""
    (w1r, w1i), (w2r, w2i) = w1, w2
    s_col = scales[:, None]
    S1, S2 = smooth_planar_pair((w1r ** 2 + w1i ** 2) / s_col,
                                (w2r ** 2 + w2i ** 2) / s_col, dt, dj, scales, mother)
    w12r, w12i = tco._cross(w1, w2)
    S12r, S12i = smooth_planar_pair(w12r / s_col, w12i / s_col, dt, dj, scales, mother)
    WCT = (S12r ** 2 + S12i ** 2) / (S1 * S2)
    return WCT, torch.atan2(w12i, w12r), (w12r, w12i)


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)], ids=["one", "rows", "pairs"])
def test_the_split_planar_coherence_is_the_old_one_bit_for_bit(lead):
    n, sj, _ = _grid()
    g = torch.Generator().manual_seed(len(lead))
    w = [torch.randn(lead + (sj.shape[0], n), generator=g) for _ in range(4)]
    kw = dict(dt=GRID["dt"], dj=GRID["dj"], mother=M6)
    new = tco._planar_coherence((w[0], w[1]), (w[2], w[3]), sj, **kw)
    old = _old_planar_coherence((w[0], w[1]), (w[2], w[3]), sj, **kw)
    for a, b in zip((new[0], new[1], *new[2]), (old[0], old[1], *old[2])):
        assert torch.equal(a, b)
    Sm, Cm, _ = tco._planar_fields((w[0], w[1]), (w[2], w[3]), sj, **kw)
    assert Sm.dtype == Cm.dtype == torch.complex64
    assert Sm.is_contiguous() and Cm.is_contiguous()
    assert torch.equal(tco._coherence_ratio(Sm, Cm), old[0])


def _chunk_kw(n, engine):
    return dict(mother=M6, nfft=tco.DEFAULT.fft_length(n), dj=GRID["dj"], n=n,
                engine=engine)


@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_the_chunk_counts_are_wct_core_and_histogram(engine):
    """``_mc_histogram_chunk`` and ``_mc_histogram_run`` against the old
    tail, ``_histogram`` of ``_wct_core``'s coherence, on the same members."""
    n, sj, oc = _grid()
    key = tst.PRNGKey(11)
    kw = _chunk_kw(n, engine)
    got = tco._mc_histogram_chunk(key, 5, sj, oc, GRID["dt"], batch=6, al1=0.5, al2=0.7,
                                  **kw)
    k1, k2 = tst.split(key)
    idx = 5 + torch.arange(6)
    y1 = tst.rednoise_members(k1, idx, n, 0.5, 1.0, dtype=torch.float32)
    y2 = tst.rednoise_members(k2, idx, n, 0.7, 1.0, dtype=torch.float32)
    R2, _, _ = tco._wct_core(y1, y2, sj, GRID["dt"], mother=M6, nfft=kw["nfft"],
                             dj=GRID["dj"], engine=engine)
    want = tco._histogram(R2, oc)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    run = tco._mc_histogram_run(key, 5, sj, oc, GRID["dt"], batch=3, nchunks=2, al1=0.5,
                                al2=0.7, **kw)
    assert torch.equal(run, want)


@pytest.mark.parametrize("engine", ["planar", "xla"])
def test_the_pair_chunks_are_wct_core_and_histogram(engine):
    """``_mc_histogram_run_pairs`` with an overdrawn last chunk (10 members
    in chunks of 4) against the old tail, chunk by chunk."""
    n, sj, oc = _grid()
    key = tst.PRNGKey(12)
    slots = torch.tensor([3, 9, 4])
    g1 = torch.tensor([0.4, 0.6, 0.2])
    g2 = torch.tensor([0.5, 0.1, 0.7])
    kw = _chunk_kw(n, engine)
    del kw["n"]
    got = tco._mc_histogram_run_pairs(key, sj, oc, slots, g1, g2, 10, GRID["dt"],
                                      batch=4, nchunks=3, n=n, tau=16, **kw)
    k1, k2 = tst.split(key)
    want = torch.zeros_like(got)
    for i in range(3):
        idx = i * 4 + torch.arange(4)
        y1 = tst.rednoise_members_pairs(k1, slots, idx, n, g1, 16)
        y2 = tst.rednoise_members_pairs(k2, slots, idx, n, g2, 16)
        R2, _, _ = tco._wct_core(y1.reshape(12, n), y2.reshape(12, n), sj, GRID["dt"],
                                 mother=M6, nfft=kw["nfft"], dj=GRID["dj"], engine=engine)
        want += tco._histogram(R2.reshape(3, 4, sj.shape[0], n), oc, valid=idx < 10)
    assert torch.equal(got, want)
    assert int(got.sum()) == 10 * 3 * int(oc.sum())


def test_the_sharded_chunk_keeps_the_counts_bins():
    """``sharded_mc_histogram`` counts through ``_mc_histogram_chunk``, whose
    counts have ``NBINS`` bins: another ``nbins`` is refused before any work."""
    from pycwt_torch.parallel import sharded_mc_histogram

    with pytest.raises(ValueError, match="nbins must be 1000"):
        sharded_mc_histogram(None, None, None, None, GRID["dt"], mother=M6, nfft=64,
                             dj=GRID["dj"], per_device_batch=2, n=50, al1=0.5, al2=0.5,
                             nbins=500)


def test_the_plain_cells_are_counted():
    """The torch path counts the points of the members it bins, past
    ``mc_count`` left out, on the CPU too; the kernel's counter stays 0."""
    n, sj, oc = _grid()
    S = sj.shape[0]
    kw = _chunk_kw(n, None)
    tco._mc_histogram_chunk(tst.PRNGKey(1), 0, sj, oc, 1.0, batch=5, al1=0.3, al2=0.4, **kw)
    assert profiling.MC_HIST_PLAIN_CELLS == 5 * S * n
    del kw["n"]
    tco._mc_histogram_run_pairs(tst.PRNGKey(2), sj, oc, torch.tensor([1, 2]),
                                torch.tensor([0.3, 0.5]), torch.tensor([0.2, 0.6]), 7, 1.0,
                                batch=3, nchunks=3, n=n, tau=8, **kw)
    assert profiling.MC_HIST_PLAIN_CELLS == (5 + 2 * 7) * S * n
    assert profiling.MC_HIST_KERNEL_CELLS == 0


# --------------------------------------------------------------------------
# The kernel's arithmetic, replayed
# --------------------------------------------------------------------------

def _bins_mirror(Sm: np.ndarray, Cm: np.ndarray) -> np.ndarray:
    """``bin_of`` of ``csrc/mc_hist.cu`` in float32 numpy, each op rounded
    on its own: R² = (cr·cr + ci·ci) / (s1·s2), f = floor(R²·1000), bin 0
    where not f > 0, 999 where f ≥ 999, else f."""
    s1, s2 = Sm.real, Sm.imag
    cr, ci = Cm.real, Cm.imag
    with np.errstate(all="ignore"):
        r2 = (cr * cr + ci * ci) / (s1 * s2)
        f = np.floor(r2 * np.float32(tco.NBINS))
        return np.where(~(f > 0), 0, np.where(f >= tco.NBINS - 1, tco.NBINS - 1,
                                              np.nan_to_num(f))).astype(np.int64)


def _counts_mirror(Sm, Cm, mask, valid):
    """The kernel's counts ``(P, S, 1000)`` of ``(P, B, S, n)`` complex64
    fields, from :func:`_bins_mirror`."""
    P, B, S, n = Sm.shape
    bins = _bins_mirror(Sm, Cm)
    keep = np.broadcast_to(mask[None, None], bins.shape) & (np.arange(B) < valid)[None, :, None, None]
    counts = np.zeros((P, S, tco.NBINS), np.int64)
    p, _, s, _ = np.nonzero(keep)
    np.add.at(counts, (p, s, bins[keep]), 1)
    return counts


def _special_fields(P, B, S, n, seed):
    """Random fields with R² up to ~1.5, then NaN, ±inf, negative and zero
    S1·S2, zero numerators, and R² within a few ulps of every bin edge k/1000
    (|C|² = k/1000 · S1·S2 in float64, split between C's two parts at random,
    rounded to float32), where the rounding order decides the bin."""
    g = torch.Generator().manual_seed(seed)
    s = torch.rand((P, B, S, n, 2), generator=g) + 0.05
    c = torch.randn((P, B, S, n, 2), generator=g) * 0.6
    Sm = torch.view_as_complex(s).clone()
    Cm = torch.view_as_complex(c).clone()
    flat_s, flat_c = Sm.view(-1), Cm.view(-1)
    N = flat_s.numel()
    at = torch.randperm(N, generator=g)
    k = torch.arange(0, 1500)
    edges = at[:min(len(k), N // 2)]
    s1 = flat_s[edges].real.double()
    s2 = flat_s[edges].imag.double()
    u = torch.rand(len(edges), generator=g, dtype=torch.float64)
    mag = k[:len(edges)] / 1000.0 * s1 * s2
    flat_c[edges] = torch.complex(torch.sqrt(mag * u).float(), torch.sqrt(mag * (1 - u)).float())
    special = at[N // 2:N // 2 + 12]
    nan, inf = float("nan"), float("inf")
    cases = [(complex(nan, 1), 1), (complex(1, nan), 1), (1 + 1j, complex(nan, 0)),
             (1 + 1j, complex(inf, 0)), (1 + 1j, complex(0, -inf)), (1 - 1j, 0.5),
             (-1 - 1j, 0.5), (0 + 1j, 0.5), (0j, 0j), (complex(1, 0), 0j),
             (complex(inf, 1), 0.5), (complex(-inf, 1), 0.5)]
    for i, (sv, cv) in zip(special.tolist(), cases):
        flat_s[i], flat_c[i] = sv, cv
    return Sm, Cm


def _masks(S, n, seed):
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((S, n), generator=g) > 0.3
    mask[0] = False                # an all-masked row
    mask[-1] = True
    return mask


@pytest.mark.parametrize("shape", [(1, 7, 5, 93), (3, 4, 6, 211)], ids=["single", "pairs"])
@pytest.mark.parametrize("valid", ["all", "fewer"])
def test_the_kernels_arithmetic_bins_as_the_torch_path(shape, valid):
    P, B, S, n = shape
    Sm, Cm = _special_fields(P, B, S, n, seed=n)
    mask = _masks(S, n, seed=S)
    v = B if valid == "all" else B - 3
    keep = None if v == B else torch.arange(B) < v
    want = tco._histogram(tco._coherence_ratio(Sm, Cm), mask, valid=keep)
    got = _counts_mirror(Sm.numpy(), Cm.numpy(), mask.numpy(), v)
    np.testing.assert_array_equal(got, want.numpy())
    assert got[:, 0].sum() == 0 and got.sum() == P * v * int(mask.sum())


# --------------------------------------------------------------------------
# The wrapper, through a stand-in for the library
# --------------------------------------------------------------------------

def _array(ptr, count, ctype):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


class StandIn:
    """The CUDA library ``mc_hist`` for CPU tensors: ``mc_coherence_counts``
    reads the fields, the mask and the counts through the pointers the
    wrapper passes and adds :func:`_counts_mirror`'s counts in place.  It
    stands in for ``torch.cuda.device`` and ``torch.cuda.current_stream``
    too, and asserts that it runs inside the guard of the fields' device,
    on that device's stream."""

    def __init__(self):
        self.calls = []
        self.guards = []
        self.streams = []

    @contextlib.contextmanager
    def device(self, dev):
        self.guards.append(dev)
        try:
            yield
        finally:
            self.guards.pop()

    def current_stream(self, device=None):
        self.streams.append(device)
        return types.SimpleNamespace(cuda_stream=0)

    def mc_coherence_counts(self, s, c, mask, acc, P, B, S, n, valid, stream):
        assert self.guards == [torch.device("cpu")] and self.streams[-1] == torch.device("cpu")
        self.calls.append((P, B, S, n, valid))
        pts = P * B * S * n
        Sm = _array(s, 2 * pts, ctypes.c_float).view(np.complex64).reshape(P, B, S, n)
        Cm = _array(c, 2 * pts, ctypes.c_float).view(np.complex64).reshape(P, B, S, n)
        m = _array(mask, S * n, ctypes.c_uint8).reshape(S, n).astype(bool)
        _array(acc, P * S * tco.NBINS, ctypes.c_int64)[:] += _counts_mirror(
            Sm, Cm, m, valid).reshape(-1)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """CPU fields take the kernel's wrapper, which calls the stand-in
    library on the CPU tensors' memory."""
    lib = StandIn()
    monkeypatch.setattr(mc_hist, "on_card", lambda fields: True)
    monkeypatch.setattr(mc_hist, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lib.device)
    monkeypatch.setattr(torch.cuda, "current_stream", lib.current_stream)
    return lib


def test_the_wrapper_adds_the_kernels_counts_in_place(stand_in):
    Sm, Cm = _special_fields(2, 5, 4, 77, seed=5)
    mask = _masks(4, 77, seed=6)
    acc = torch.arange(2 * 4 * tco.NBINS, dtype=torch.int64).view(2, 4, tco.NBINS)
    before = acc.clone()
    launches = mc_hist.LAUNCHES["mc_coherence_counts"]
    assert mc_hist.coherence_counts(Sm, Cm, mask, 4, acc) is acc
    mc_hist.coherence_counts(Sm, Cm, mask, 0, acc)        # no member: no launch
    want = tco._histogram(tco._coherence_ratio(Sm, Cm), mask, valid=torch.arange(5) < 4)
    assert torch.equal(acc - before, want)
    assert stand_in.calls == [(2, 5, 4, 77, 4)]
    assert mc_hist.LAUNCHES["mc_coherence_counts"] == launches + 1
    assert profiling.MC_HIST_KERNEL_CELLS == 2 * 4 * 4 * 77


def test_the_chunks_through_the_kernel_equal_the_torch_path(stand_in, monkeypatch):
    """``_mc_histogram_chunk`` and ``_mc_histogram_run_pairs`` (an overdrawn
    last chunk) on the planar route through the wrapper, against the same
    calls on the torch path; each chunk is one launch, no phase is
    computed, and each road counts its own points."""
    n, sj, oc = _grid()
    S = sj.shape[0]
    kw = _chunk_kw(n, "planar")
    pair_kw = dict(kw, n=n)
    del kw["n"]
    args = (tst.PRNGKey(21), sj, oc, torch.tensor([5, 8]), torch.tensor([0.35, 0.55]),
            torch.tensor([0.6, 0.15]), 7, 1.0)

    def atan2(*a):
        raise AssertionError("the Monte-Carlo chunk computed a phase")

    with monkeypatch.context() as m:
        m.setattr(torch, "atan2", atan2)
        single = tco._mc_histogram_chunk(tst.PRNGKey(20), 3, sj, oc, 1.0, batch=6,
                                         al1=0.4, al2=0.6, **pair_kw)
        pairs = tco._mc_histogram_run_pairs(*args, batch=3, nchunks=3, n=n, tau=8, **kw)
    assert stand_in.calls == [(1, 6, S, n, 6)] + [
        (2, 3, S, n, v) for v in (3, 3, 1)]
    assert profiling.MC_HIST_KERNEL_CELLS == (6 + 2 * 7) * S * n
    assert profiling.MC_HIST_PLAIN_CELLS == 0
    with monkeypatch.context() as m:
        m.setattr(mc_hist, "on_card", lambda fields: False)
        assert torch.equal(single, tco._mc_histogram_chunk(
            tst.PRNGKey(20), 3, sj, oc, 1.0, batch=6, al1=0.4, al2=0.6, **pair_kw))
        assert torch.equal(pairs, tco._mc_histogram_run_pairs(
            *args, batch=3, nchunks=3, n=n, tau=8, **kw))
    assert profiling.MC_HIST_PLAIN_CELLS == (6 + 2 * 7) * S * n


def test_the_off_planar_route_never_takes_the_kernel(stand_in):
    n, sj, oc = _grid()
    tco._mc_histogram_chunk(tst.PRNGKey(4), 0, sj, oc, 1.0, batch=3, al1=0.4, al2=0.6,
                            **_chunk_kw(n, "xla"))
    assert stand_in.calls == [] and profiling.MC_HIST_KERNEL_CELLS == 0


def _fields(P=1, B=3, S=4, n=20):
    Sm = torch.ones((P, B, S, n), dtype=torch.complex64)
    return Sm, Sm.clone(), torch.ones((S, n), dtype=torch.bool), torch.zeros(
        (P, S, tco.NBINS), dtype=torch.int64)


@pytest.mark.parametrize("fault, error, match", [
    ("complex128 fields", TypeError, "complex64"),
    ("float mask", TypeError, "bool"),
    ("int32 counts", TypeError, "int64"),
    ("3-D fields", ValueError, "P, B, S, n"),
    ("fields of two shapes", ValueError, "P, B, S, n"),
    ("mask of another shape", ValueError, "the mask is"),
    ("counts of another shape", ValueError, "the mask is"),
    ("strided fields", ValueError, "contiguous"),
    ("valid above B", ValueError, "valid members"),
    ("valid below 0", ValueError, "valid members"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(stand_in, fault, error, match):
    Sm, Cm, mask, acc = _fields()
    valid = 3
    if fault == "complex128 fields":
        Sm = Sm.to(torch.complex128)
    elif fault == "float mask":
        mask = mask.float()
    elif fault == "int32 counts":
        acc = acc.int()
    elif fault == "3-D fields":
        Sm, Cm = Sm[0], Cm[0]
    elif fault == "fields of two shapes":
        Cm = Cm[:, :2]
    elif fault == "mask of another shape":
        mask = mask[:, :5]
    elif fault == "counts of another shape":
        acc = acc[..., :500]
    elif fault == "strided fields":
        Sm = torch.ones((1, 3, 20, 4), dtype=torch.complex64).transpose(2, 3)
    else:
        valid = 4 if fault == "valid above B" else -1
    with pytest.raises(error, match=match):
        mc_hist.coherence_counts(Sm, Cm, mask, valid, acc)
    assert stand_in.calls == []


def test_the_wrapper_refuses_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU fields loaded {name}")

    monkeypatch.setattr(mc_hist, "library", refuse)
    with pytest.raises(ValueError, match="one CUDA device"):
        mc_hist.coherence_counts(*_fields()[:3], 3, _fields()[3])


# --------------------------------------------------------------------------
# The counters and their reader
# --------------------------------------------------------------------------

def test_enable_spans_clears_the_point_counters():
    profiling.MC_HIST_KERNEL_CELLS, profiling.MC_HIST_PLAIN_CELLS = 5, 2
    profiling.enable_spans()
    assert profiling.MC_HIST_KERNEL_CELLS == profiling.MC_HIST_PLAIN_CELLS == 0


def test_mc_hist_kernel_pct_reads_the_counters(monkeypatch):
    """The reader: nothing before a point is counted, 100 with kernel points
    only, then 100·kernel / (kernel + plain); over a program without the
    counters, or without the recorder, nothing, and no error."""
    mod = harness.load_module("metrics", "mc_hist_kernel_pct")
    assert profiling._on and mod.read(None) is None
    profiling.MC_HIST_KERNEL_CELLS = 300
    assert mod.read(None) == 100.0
    profiling.MC_HIST_PLAIN_CELLS = 100
    assert mod.read(None) == 75.0
    for attr in ("MC_HIST_KERNEL_CELLS", "MC_HIST_PLAIN_CELLS"):
        monkeypatch.delattr(profiling, attr)
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert harness.load_module("metrics", "mc_hist_kernel_pct").read(None) is None
