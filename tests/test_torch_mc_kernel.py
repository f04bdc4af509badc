"""The Monte-Carlo generator kernels' host side on the CPU
(``pycwt_torch/ops/mc_noise.py``, ``csrc/mc_noise.cu``): the kernel's scan
order against ``stats._ar1_recurrence`` bit for bit; the dispatch on the
key's device (a CPU key never loads the library); the wrappers through a
stand-in for the CUDA library, which computes what the kernels compute from
the pointers they are given, against the torch code bit for bit; the row
counters; and the benchmark's reader of them, ``mc_kernel_rows_pct``.  The
kernels themselves run on the card in ``test_torch_mc_cuda.py``."""
import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from cwtbench import harness
from pycwt_torch import stats as tst
from pycwt_torch.ops import mc_noise
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
_CTYPE = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double,
          torch.int64: ctypes.c_int64}


def _scan_mirror(z: torch.Tensor, g, threads: int = 512) -> torch.Tensor:
    """``mc_rednoise``'s AR(1) scan in its own order: at the step of width d,
    b[t] = G·b[t − d] + b[t] for t ≥ d over chunks of ``threads`` entries
    from the top down, then G = G·G, from G = g in ``z``'s type (``g`` a
    float or a tensor broadcastable to ``z``'s rows)."""
    b = z.clone()
    L = b.shape[-1]
    G = torch.as_tensor(g, dtype=b.dtype).expand(b.shape[:-1] + (1,))
    d = 1
    while d < L:
        for c in range(-(-L // threads) - 1, -1, -1):
            lo, hi = max(c * threads, d), min((c + 1) * threads, L)
            if lo < hi:
                b[..., lo:hi] = G * b[..., lo - d:hi - d] + b[..., lo:hi]
        G = G * G
        d *= 2
    return b


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


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES)
@pytest.mark.parametrize("g", [0.5, -0.3, 0.8, 0.99, -0.97])
@pytest.mark.parametrize("length", [1, 2, 50, 1024, 1025, 6302 + 199])
def test_the_kernels_scan_order_equals_ar1_recurrence(dtype, g, length):
    """One scalar G_k = G_{k-1}² a step in place of the array a, in place
    over chunks from the top down: the bits of the Hillis–Steele scan."""
    z = torch.randn((3, length), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(length)).to(dtype)
    want = tst._ar1_recurrence(z, g)
    for threads in (32, 512):
        assert torch.equal(_scan_mirror(z, g, threads), want)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES)
def test_the_kernels_scan_order_with_a_g_a_row(dtype):
    z = torch.randn((3, 5, 777), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3)).to(dtype)
    g = torch.tensor([0.0, -0.45, 0.97], dtype=dtype)
    assert torch.equal(_scan_mirror(z, g[:, None, None], 64),
                       tst._ar1_recurrence(z, g[:, None, None]))


def test_a_cpu_key_never_loads_the_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a CPU key loaded {name}")

    monkeypatch.setattr(mc_noise, "library", refuse)
    key = tst.PRNGKey(7)
    k1, k2 = tst.split(key)
    tst.fold_in(key, torch.arange(5))
    for dtype in DTYPES.values():
        for g in (0.0, 0.6):
            assert tst.rednoise_members(k1, torch.arange(4), 30, g, dtype=dtype).shape == (4, 30)
    tst.rednoise_members_pairs(k2, [0, 3], torch.arange(4), 30,
                               torch.tensor([0.2, 0.5]), 3)
    assert profiling.MC_KERNEL_ROWS == profiling.MC_PLAIN_ROWS == 0
    assert not tst._on_card(key)


def _word(ptr):
    return torch.tensor(ctypes.c_int64.from_address(ptr).value)


def _values(ptr, count, dtype):
    return np.ctypeslib.as_array((_CTYPE[dtype] * count).from_address(ptr))


def _ints(ptr, count):
    return torch.from_numpy(_values(ptr, count, torch.int64).copy())


class StandIn:
    """The CUDA library ``mc_noise`` for CPU tensors: each entry reads its
    arguments through the pointers the wrapper passes and writes what the
    kernel writes, computed with the torch code's threefry and erfinv and
    the kernel's scan order (:func:`_scan_mirror`).  It stands in for
    ``torch.cuda.device`` and ``torch.cuda.current_stream`` too, and each
    entry asserts that it runs inside the guard of the key's device, on that
    device's stream."""

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

    def _on_the_keys_device(self):
        key_device = torch.device("cpu")
        assert self.guards == [key_device] and self.streams[-1] == key_device

    def mc_fold_in(self, k0, k1, data, count, out0, out1, stream):
        self._on_the_keys_device()
        self.calls.append("mc_fold_in")
        x = torch.arange(count) if data is None else _ints(data, count) & 0xFFFFFFFF
        w0, w1 = tst._threefry2x32(_word(k0), _word(k1), torch.zeros_like(x), x)
        _values(out0, count, torch.int64)[:] = w0.numpy()
        _values(out1, count, torch.int64)[:] = w1.numpy()
        return 0

    def _rednoise(self, dtype, k0, k1, slots, idx, rows, members, L, tau, g, g_rows, a,
                  scale, lo, scan, out, stream):
        self._on_the_keys_device()
        self.calls.append(("mc_rednoise", dtype, bool(scan)))
        pairs = rows // members
        m = _ints(idx, members) & 0xFFFFFFFF
        r0, r1 = _word(k0), _word(k1)
        if slots is not None:
            s = _ints(slots, pairs) & 0xFFFFFFFF
            r0, r1 = tst._threefry2x32(r0, r1, torch.zeros_like(s), s)
            r0, r1 = r0[:, None], r1[:, None]
        r0, r1 = tst._threefry2x32(r0, r1, torch.zeros_like(m), m)
        t = torch.arange(L)
        hi, lo_w = tst._threefry2x32(r0.reshape(-1, 1), r1.reshape(-1, 1),
                                     torch.zeros_like(t), t)
        u = ((hi << 20) | (lo_w >> 12)).to(torch.float64) * 2.0 ** -52
        u = torch.clamp_min(u * scale + lo, lo)
        z = (math.sqrt(2.0) * torch.erfinv(u)).to(dtype) * torch.tensor(a, dtype=dtype)
        if scan:
            G = (torch.from_numpy(_values(g_rows, pairs, dtype).copy())
                 .repeat_interleave(members)[:, None]
                 if g_rows is not None else torch.tensor(g, dtype=dtype))
            z = _scan_mirror(z, G)
        _values(out, rows * L, dtype)[:] = z.reshape(-1).numpy()
        return 0

    def mc_rednoise_f32(self, *args):
        return self._rednoise(torch.float32, *args)

    def mc_rednoise_f64(self, *args):
        return self._rednoise(torch.float64, *args)


@pytest.fixture
def stand_in(monkeypatch):
    """CPU keys take the kernels' wrappers, which call the stand-in library
    on the CPU tensors' memory."""
    lib = StandIn()
    monkeypatch.setattr(tst, "_on_card", lambda key: True)
    monkeypatch.setattr(mc_noise, "_key_words", tuple)
    monkeypatch.setattr(mc_noise, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lib.device)
    monkeypatch.setattr(torch.cuda, "current_stream", lib.current_stream)
    return lib


def _plain(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(tst, "_on_card", lambda key: False)
        return fn()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1, 2 ** 40 + 3])
def test_split_and_fold_in_through_the_wrappers(stand_in, monkeypatch, seed):
    key = tst.PRNGKey(seed)
    data = torch.tensor([[0, 1, 299], [2 ** 31 - 5, -1, 7]])
    before = mc_noise.LAUNCHES["mc_fold_in"]
    got = [tst.split(key), tst.split(key, 5), tst.fold_in(key, data), tst.fold_in(key, 3)]
    assert mc_noise.LAUNCHES["mc_fold_in"] - before == 4 == len(stand_in.calls)
    want = _plain(monkeypatch, lambda: [tst.split(key), tst.split(key, 5),
                                        tst.fold_in(key, data), tst.fold_in(key, 3)])
    for g_keys, w_keys in zip(got[:2], want[:2]):
        assert len(g_keys) == len(w_keys)
        for gk, wk in zip(g_keys, w_keys):
            for a, b in zip(gk, wk):
                _same(a, b)
    for g_words, w_words in zip(got[2:], want[2:]):
        for a, b in zip(g_words, w_words):
            _same(a, b)


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES)
@pytest.mark.parametrize("g", [0.0, 0.5, -0.3, 0.99])
@pytest.mark.parametrize("start", [0, 2 ** 31 - 12])
def test_rednoise_members_through_the_wrapper(stand_in, monkeypatch, dtype, g, start):
    """The rows, their view (columns tau: of rows of n + tau) and the
    counters; g = 0 asks for no scan."""
    idx = start + torch.arange(24)
    key = tst.split(tst.PRNGKey(2 ** 31 + 977))[1]
    got = tst.rednoise_members(key, idx, 120, g, 1.7, dtype=dtype)
    assert stand_in.calls == ["mc_fold_in", ("mc_rednoise", dtype, g != 0.0)]
    assert (profiling.MC_KERNEL_ROWS, profiling.MC_PLAIN_ROWS) == (24, 0)
    _same(got, _plain(monkeypatch,
                      lambda: tst.rednoise_members(key, idx, 120, g, 1.7, dtype=dtype)))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES)
def test_rednoise_members_pairs_through_the_wrapper(stand_in, monkeypatch, dtype):
    key = tst.PRNGKey(5)
    slots, idx = torch.tensor([0, 5, 2 ** 31 - 1]), 290 + torch.arange(7)
    g = torch.tensor([0.0, -0.45, 0.97], dtype=torch.float64)
    got = tst.rednoise_members_pairs(key, slots, idx, 60, g, 9, dtype=dtype)
    assert stand_in.calls == [("mc_rednoise", dtype, True)]
    assert profiling.MC_KERNEL_ROWS == 21
    _same(got, _plain(monkeypatch,
                      lambda: tst.rednoise_members_pairs(key, slots, idx, 60, g, 9,
                                                         dtype=dtype)))


@pytest.mark.parametrize("dtype", DTYPES.values(), ids=DTYPES)
def test_long_rows_through_the_wrapper(stand_in, monkeypatch, dtype):
    """The long nulls' rows (6,302 samples, tau 199 at g 0.99) take the one
    kernel, in f32 and f64 alike, and equal the torch code."""
    key = tst.PRNGKey(3)
    got = tst.rednoise_members(key, torch.arange(2), 6302, 0.99, dtype=dtype)
    assert stand_in.calls[-1] == ("mc_rednoise", dtype, True)
    _same(got, _plain(monkeypatch,
                      lambda: tst.rednoise_members(key, torch.arange(2), 6302, 0.99,
                                                   dtype=dtype)))


def test_the_card_refuses_rows_the_kernel_does_not_draw(stand_in):
    """A card key takes the kernel and nothing else: half-precision rows and
    a g with |g| ≥ 1 raise, and no row is drawn by either road."""
    key = tst.PRNGKey(3)
    with pytest.raises(TypeError, match="float32 or float64"):
        tst.rednoise_members(key, torch.arange(4), 30, 0.5, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or float64"):
        tst.rednoise_members_pairs(key, [0, 3], torch.arange(4), 30,
                                   torch.tensor([0.2, 0.5]), 3, dtype=torch.float16)
    for g in (2.0, -1.5):
        with pytest.raises(ValueError, match=r"\|g\| < 1"):
            tst.rednoise_members(key, torch.arange(4), 30, g)
    assert not any(isinstance(c, tuple) for c in stand_in.calls)
    assert profiling.MC_KERNEL_ROWS == profiling.MC_PLAIN_ROWS == 0


def test_the_card_rows_of_the_torch_path_are_counted():
    """``MC_PLAIN_ROWS`` counts rows drawn on the card only."""
    tst._count_plain(torch.zeros(3, 10))
    assert profiling.MC_PLAIN_ROWS == 0
    tst._count_plain(types.SimpleNamespace(is_cuda=True, shape=(2, 5, 10),
                                           numel=lambda: 100))
    assert profiling.MC_PLAIN_ROWS == 10


def test_the_wrapper_refuses_what_the_kernel_does_not_take(stand_in):
    key = tst.PRNGKey(3)
    with pytest.raises(TypeError, match="float32 or float64"):
        mc_noise.rednoise(key, torch.arange(3), 10, 2, 0.5, dtype=torch.float16)
    with pytest.raises(ValueError, match="one row"):
        mc_noise.rednoise(key, torch.zeros(2, 2, dtype=torch.int64), 10, 2, 0.5)
    with pytest.raises(ValueError, match="tau >= 0"):
        mc_noise.rednoise(key, torch.arange(3), 10, -1, 0.5)
    with pytest.raises(ValueError, match=r"\|g\| < 1"):
        mc_noise.rednoise(key, torch.arange(3), 10, 2, 1.0)
    with pytest.raises(ValueError, match="one length"):
        mc_noise.rednoise(key, torch.arange(3), 10, 2, [0.5], slots=[1, 2])
    assert stand_in.calls == []


def test_the_key_must_lie_on_the_card():
    with pytest.raises(ValueError, match="CUDA device"):
        mc_noise.split(tst.PRNGKey(3))


def test_enable_spans_clears_the_row_counters():
    profiling.MC_KERNEL_ROWS, profiling.MC_PLAIN_ROWS = 5, 2
    profiling.enable_spans()
    assert profiling.MC_KERNEL_ROWS == profiling.MC_PLAIN_ROWS == 0


def test_mc_kernel_rows_pct_reads_the_counters(monkeypatch):
    """The reader: nothing before a row is counted, then 100·kernel / (kernel
    + plain); over a program without the counters, or without the recorder,
    nothing, and no error."""
    mod = harness.load_module("metrics", "mc_kernel_rows_pct")
    assert profiling._on and mod.read(None) is None
    profiling.MC_KERNEL_ROWS = 600
    assert mod.read(None) == 100.0
    profiling.MC_PLAIN_ROWS = 200
    assert mod.read(None) == 75.0
    for attr in ("MC_KERNEL_ROWS", "MC_PLAIN_ROWS"):
        monkeypatch.delattr(profiling, attr)
    assert mod.read(None) is None
    for attr in ("enable_spans", "span_summary"):
        monkeypatch.delattr(profiling, attr)
    assert harness.load_module("metrics", "mc_kernel_rows_pct").read(None) is None
