"""``api._host``, the port's fetch of a result to host numpy, on the CPU: a
CPU tensor and a card tensor under ``_PINNED_MIN_BYTES`` take the pageable
path and leave the pinned counter at 0; a pinned allocation that fails, or
whose block finds no room under the cap once the idle blocks went back,
falls back; a dropped result's block serves the next fetch of its size,
also after a burst that filled the pool; ``enable_spans`` resets the
counter; and the benchmark's ``fetch_pinned_hit_pct.power`` reads the share
of pinned fetches that found a cached block, and nothing where there is none.

The card's own pinned fetches are in ``tests/test_torch_host_fetch_cuda.py``;
here a stand-in for a card tensor reports ``is_cuda``, and where a test
needs pinned allocations to succeed a stand-in for torch's caching host
allocator serves them from CPU memory."""
import weakref

import numpy as np
import pytest
import torch

from pycwt_torch import api
from pycwt_torch.utils import profiling


@pytest.fixture(autouse=True)
def counters_clear():
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


class _OnCard:
    """What ``_host`` reads of a card tensor, over a CPU tensor."""

    is_cuda = True

    def __init__(self, t):
        self.t, self.shape, self.dtype = t, t.shape, t.dtype

    def detach(self):
        return self

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()

    def cpu(self):
        return self.t


@pytest.fixture
def pin_calls(monkeypatch):
    """Records each pinned allocation asked of ``torch.empty``; the
    allocation raises, as it does without a card."""
    calls = []
    empty = torch.empty

    def spy(*args, pin_memory=False, **kw):
        if pin_memory:
            calls.append(args)
            raise RuntimeError("page-locked memory exhausted")
        return empty(*args, **kw)

    monkeypatch.setattr(torch, "empty", spy)
    return calls


class _Pool:
    """Torch's caching host allocator as ``_host`` sees it: a pinned
    ``torch.empty`` takes a free block of its size, rounded up to a power of
    two, or creates one; the block is free again once every tensor and array
    over it has died; the stats report the bytes held and the blocks
    created; emptying the cache hands the free blocks back."""

    def __init__(self, monkeypatch):
        self.free, self.held, self.created = {}, 0, 0
        self.reads = self.emptied = 0
        empty = torch.empty

        def pinned(*args, pin_memory=False, **kw):
            if not pin_memory:
                return empty(*args, **kw)
            buf = empty(*args, **kw).numpy()
            size = 1 << (buf.nbytes - 1).bit_length()
            if self.free.get(size):
                self.free[size] -= 1
            else:
                self.created += 1
                self.held += size
            weakref.finalize(buf, self._drop, size)
            return torch.from_numpy(buf)

        monkeypatch.setattr(torch, "empty", pinned)
        monkeypatch.setattr(torch.cuda.memory,
                            "host_memory_stats_as_nested_dict", self._stats)
        monkeypatch.setattr(torch._C, "_host_emptyCache", self._empty,
                            raising=False)

    def _drop(self, size):
        self.free[size] = self.free.get(size, 0) + 1

    def _stats(self):
        self.reads += 1
        return {"allocated_bytes": {"current": self.held},
                "allocations": {"allocated": self.created}}

    def _empty(self):
        self.emptied += 1
        self.held -= sum(size * n for size, n in self.free.items())
        self.free.clear()


@pytest.fixture
def pool(monkeypatch):
    return _Pool(monkeypatch)


def _counters():
    return profiling.HOST_PINNED_FETCHES


M = api._PINNED_MIN_BYTES


def _floats(nbytes, value=0.0):
    return torch.full((nbytes // 4,), float(value))


def test_a_cpu_tensor_takes_the_pageable_path(pin_calls):
    t = torch.arange(1 << 16, dtype=torch.float32).reshape(256, 256)
    out = api._host(t)
    assert np.shares_memory(out, t.numpy())
    assert pin_calls == [] and _counters() == 0
    assert profiling.HOST_BYTES == t.numel() * 4


@pytest.mark.parametrize("shape,dtype", [((76, 147), torch.float32),
                                         ((1, M // 8 - 1), torch.complex64)],
                         ids=["wct_map", "under_by_8"])
def test_a_card_tensor_under_the_constant_takes_the_pageable_path(
        pin_calls, shape, dtype):
    t = torch.ones(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    assert nbytes < M
    out = api._host(_OnCard(t))
    np.testing.assert_array_equal(out, t.numpy())
    assert pin_calls == [] and _counters() == 0
    assert profiling.HOST_BYTES == nbytes


def test_a_failed_pinned_allocation_falls_back(pin_calls):
    t = _floats(M, 1.0)
    out = api._host(_OnCard(t))
    np.testing.assert_array_equal(out, t.numpy())
    assert len(pin_calls) == 1 and _counters() == 0
    assert profiling.HOST_BYTES == t.numel() * 4


def test_a_pool_at_its_cap_takes_no_block(pool, monkeypatch):
    """With the blocks in use filling the cap, a fetch that needs a new
    block goes pageable after the idle blocks went back; one whose block
    fits takes it.  The guard counts the block rounded up to a power of
    two: a result 4 bytes over the constant needs twice the constant."""
    monkeypatch.setattr(api, "_PINNED_CAP_BYTES", 4 * M + M // 2)
    held = [api._pinned(_floats(M)), api._pinned(_floats(2 * M))]
    idle = api._pinned(_floats(M))
    del idle
    assert pool.held == 4 * M and pool.created == 3 and _counters() == 3
    t = torch.zeros(M // 4 + 1)
    out = api._host(_OnCard(t))
    np.testing.assert_array_equal(out, t.numpy())
    assert pool.emptied == 1 and pool.held == 3 * M and pool.created == 3
    assert _counters() == 3
    fits = api._pinned(_floats(M, 3.0))
    assert fits is not None and (fits == 3.0).all()
    assert pool.held == 4 * M and pool.created == 4 and pool.emptied == 1
    assert _counters() == 4 and len(held) == 2


def test_the_cap_is_a_quarter_of_the_machine():
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert api._PINNED_CAP_BYTES == ram // 4 > 0


def test_pinned_fetches_count_their_growths(pool):
    """The program counts its pinned fetches; the allocator's count of
    blocks grows only where no block of the size is free: a dropped
    result's block serves the next fetch of its size, a held one does not.
    Results never share memory and read what was fetched."""
    n = M // 4 * 3                                # 3 × the constant: a block of 4 ×
    src = [torch.full((n,), float(k)) for k in range(4)]
    a = api._pinned(src[0])
    assert (_counters(), pool.created) == (1, 1)
    del a
    b = api._pinned(src[1])
    assert (_counters(), pool.created) == (2, 1)
    c = api._pinned(src[2])
    assert (_counters(), pool.created) == (3, 2)
    assert not np.shares_memory(b, c)
    for got, k in ((b, 1), (c, 2)):
        assert got.flags.c_contiguous and got.flags.writeable
        np.testing.assert_array_equal(got, src[k].numpy())
    assert pool.held == 2 * 4 * M
    del b, c
    d = api._pinned(src[3].reshape(3, -1))        # same block size, another shape
    assert (_counters(), pool.created) == (4, 2) and d.shape == (3, n // 3)
    assert pool.emptied == 0


def test_a_burst_then_a_loop_stays_pinned(pool, monkeypatch):
    """A burst of live results grows the pool and is dropped: later fetches
    of that size take the cached blocks, pinned and with no growth.  Where
    the idle blocks leave a fetch no room under the cap, they go back to
    the system and the fetch takes one new block, still pinned, which the
    loop then reuses."""
    monkeypatch.setattr(api, "_PINNED_CAP_BYTES", 16 * M)

    def loop(k0):
        for k in range(k0, k0 + 5):
            out = api._pinned(_floats(2 * M, k))
            assert out is not None and (out == k).all()
            del out

    burst = [api._pinned(_floats(2 * M, k)) for k in range(3)]
    assert pool.held == 6 * M and pool.created == 3
    del burst
    loop(0)
    assert _counters() == 8 and pool.created == 3 and pool.emptied == 0
    monkeypatch.setattr(api, "_PINNED_CAP_BYTES", 7 * M)
    loop(5)
    assert _counters() == 13 and pool.created == 4 and pool.emptied == 1
    assert pool.held == 2 * M


def test_a_fetch_reads_the_allocator_once(pool):
    """Below the cap a pinned fetch reads the host allocator's stats once
    and empties nothing."""
    for k in range(3):
        out = api._pinned(_floats(M, k))
        del out
    assert pool.reads == 3 and pool.emptied == 0 and _counters() == 3


def test_enable_spans_resets_the_pinned_counters():
    profiling.HOST_PINNED_FETCHES = 7
    profiling.HOST_BYTES = 11
    profiling.enable_spans()
    assert (profiling.HOST_BYTES, _counters()) == (0, 0)
    profiling.HOST_PINNED_FETCHES = 5
    profiling.enable_spans()            # already on: nothing is cleared
    assert _counters() == 5


PINNED_METRIC = "fetch_pinned_hit_pct.power"


class _HostStats:
    """Torch's host allocator stats as the benchmark's hit-share metric
    reads them, on a process where CUDA runs: the blocks created since the
    last reset of the accumulated stats, and the resets asked for."""

    def __init__(self, monkeypatch, created=0):
        self.created, self.resets = created, 0
        memory = torch.cuda.memory
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(memory, "host_memory_stats_as_nested_dict",
                            lambda: {"allocations": {"allocated": self.created}})
        monkeypatch.setattr(memory, "reset_accumulated_host_memory_stats", self._reset)

    def _reset(self):
        self.created = 0
        self.resets += 1


def _metric():
    from cwtbench import harness

    return harness.load_module("metrics", PINNED_METRIC)


def test_the_pinned_hit_share_reads_the_counters(monkeypatch):
    """100 × (1 − grows / fetches) over the window; nothing without a
    pinned fetch, nothing over a program without the counter, and nothing
    raised over one without the recorder."""
    mod = _metric()
    assert mod.read(None) is None
    stats = _HostStats(monkeypatch, created=3)
    monkeypatch.setattr(profiling, "HOST_PINNED_FETCHES", 200)
    assert mod.read(None) == pytest.approx(98.5)
    stats.created = 0
    assert mod.read(None) == 100.0
    monkeypatch.delattr(profiling, "HOST_PINNED_FETCHES")
    assert mod.read(None) is None
    monkeypatch.delattr(profiling, "enable_spans")
    assert _metric().read(None) is None


def test_loading_the_pinned_hit_share_clears_the_counters(monkeypatch):
    """Loaded after the warm-up, it leaves the warm-up's fetches and growth
    out; loaded again after the window, to read it, it keeps the window's."""
    stats = _HostStats(monkeypatch, created=5)
    monkeypatch.setattr(profiling, "HOST_PINNED_FETCHES", 2)
    assert _metric().read(None) is None
    assert _counters() == 0
    assert (stats.created, stats.resets) == (0, 1)
    monkeypatch.setattr(profiling, "HOST_PINNED_FETCHES", 40)
    stats.created = 1
    assert _metric().read(None) == pytest.approx(97.5)
    assert stats.resets == 1
