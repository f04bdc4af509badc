"""``api._host`` on the card: a large result comes home through a
page-locked block of torch's caching host allocator and reads bit for bit
what ``.cpu().numpy()`` reads; live results never share a block; a dropped
result's block serves the next fetch of its size without growing the pool,
also after a burst, and idle blocks that leave no room under the cap go
back to the system; a pinned allocation that raises falls back to the
pageable path.  They
need an NVIDIA card, so they skip where there is none; ``python -m pytest
--noconftest tests/test_torch_host_fetch_cuda.py`` on the card runs them."""
import gc

import numpy as np
import pytest
import torch

from pycwt_torch import api
from pycwt_torch.utils import profiling


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: pinned host memory needs CUDA")
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield torch.device("cuda")
    gc.collect()


def _counters():
    """The port's pinned fetches, and the blocks torch's host allocator has
    created."""
    stats = torch.cuda.memory.host_memory_stats_as_nested_dict()
    return profiling.HOST_PINNED_FETCHES, stats["allocations"]["allocated"]


def _check(got, t):
    want = t.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.flags.c_contiguous and got.flags.writeable
    assert got.tobytes() == want.tobytes()


def test_the_power_slice_is_fetched_bit_for_bit(cuda):
    """The (229, 2^20)[:, :10^6] slice that ``cwt_power`` fetches."""
    full = torch.empty((229, 1 << 20), device=cuda).normal_()
    t = full[:, :10 ** 6]
    got = api._host(t)
    assert _counters()[0] == 1
    _check(got, t)
    assert profiling.HOST_BYTES == t.numel() * 4


def test_a_complex_w_is_fetched_bit_for_bit(cuda):
    full = torch.randn((64, 1 << 16), dtype=torch.complex64, device=cuda)
    t = full[:, :60_000]
    got = api._host(t)
    assert _counters()[0] == 1
    _check(got, t)


def test_a_coherence_map_stays_pageable(cuda):
    t = torch.rand((76, 147), device=cuda)
    created = _counters()[1]
    got = api._host(t)
    assert _counters() == (0, created)
    _check(got, t)


def test_live_results_keep_their_own_blocks(cuda):
    src = torch.empty((64, 1 << 16), device=cuda)
    held = api._host(src.fill_(-1.0))
    others = []
    for k in range(5):
        others.append(api._host(src.fill_(float(k))))
        assert not np.shares_memory(held, others[-1])
        assert all(not np.shares_memory(a, others[-1]) for a in others[:-1])
    assert (held == -1.0).all()
    for k, a in enumerate(others):
        assert (a == k).all()


def test_a_dropped_block_serves_the_next_fetch(cuda):
    src = torch.ones((48, 1 << 16), device=cuda)      # 12 MiB: a 16 MiB block
    first = api._host(src)
    del first
    fetches, created = _counters()
    again = api._host(src * 2)
    assert _counters() == (fetches + 1, created)
    assert (again == 2.0).all()


def test_a_raising_pinned_allocation_falls_back(cuda, monkeypatch):
    empty = torch.empty

    def refuse(*args, pin_memory=False, **kw):
        if pin_memory:
            raise RuntimeError("page-locked memory exhausted")
        return empty(*args, **kw)

    full = torch.empty((229, 1 << 16), device=cuda).normal_()
    t = full[:, :60_000]
    created = _counters()[1]
    monkeypatch.setattr(torch, "empty", refuse)
    got = api._host(t)
    assert _counters() == (0, created)
    _check(got, t)


def test_a_burst_then_a_loop_stays_pinned(cuda, monkeypatch):
    """Blocks a burst left idle serve later fetches of their size; where
    they leave no room under the cap, they go back to the system and the
    fetch takes one new block."""
    src = torch.ones((48, 1 << 16), device=cuda)      # 12 MiB: a 16 MiB block
    burst = [api._host(src) for _ in range(3)]
    del burst
    fetches, created = _counters()
    for k in range(3):
        again = api._host(src * k)
        assert (again == k).all()
        del again
    assert _counters() == (fetches + 3, created)
    monkeypatch.setattr(api, "_PINNED_CAP_BYTES", api._pool_bytes() + (8 << 20))
    again = api._host(src * 5)
    assert _counters() == (fetches + 4, created + 1)
    assert (again == 5).all()
    assert api._pool_bytes() <= api._PINNED_CAP_BYTES
