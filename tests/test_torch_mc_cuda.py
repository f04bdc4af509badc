"""The Monte-Carlo significance and the f64 routing on the card: the
generator's words on CPU and CUDA, the generator kernels (``mc_fold_in``,
``mc_rednoise``) against the torch code on the card bit for bit, curves and
histograms bit-identical across ``mc_batch`` and ``pair_block`` on both
kernel routes, the f64 curve equal to the CPU's, and the NINO3 golden at
1e-10 with an f64 config and the default engine.  They need an NVIDIA card,
so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_mc_cuda.py`` on the card runs them."""
import os

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mc_noise
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
#: JAO/JBaltic's Monte-Carlo shape (S = 76, n = 885, nfft = 1024)
JAO = dict(dt=0.25, dj=1 / 12, s0=0.48400665459719555, J=75)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(params=["0", "1"], ids=["K1K2", "K3"])
def route(request, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_SMALL_KERNEL", request.param)
    return request.param


def _rel_err(a, b):
    mask = np.abs(b) > 1e-12 * np.abs(b).max()
    return float((np.abs(a - b)[mask] / np.abs(b)[mask]).max())


def test_generator_words_equal_on_cpu_and_cuda(cuda):
    idx = torch.arange(300)
    words = [tst.fold_in(tst.PRNGKey(7, device=d), idx.to(d)) for d in ("cpu", cuda)]
    for w_cpu, w_cuda in zip(*words):
        assert torch.equal(w_cpu, w_cuda.cpu())
    z = [tst._normal_f64(w, 885) for w in words]
    assert float((z[0] - z[1].cpu()).abs().max()) < 1e-13
    key = tst.PRNGKey(7, device=cuda)
    assert key[0].device.type == "cuda"


@pytest.fixture
def torch_path(monkeypatch):
    """Call ``torch_path(fn)`` to run ``fn()`` with the card's keys on the
    generator's torch code instead of the kernels."""
    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(tst, "_on_card", lambda key: False)
            return fn()
    return run


def _same(got, want):
    """Bit for bit, and the same view (shape, strides) of its rows."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 40 + 3])
def test_split_and_fold_in_kernel_equal_the_torch_path(cuda, torch_path, seed):
    key = tst.PRNGKey(seed, device=cuda)
    data = torch.tensor([[0, 1, 2, 299], [2 ** 31 - 8, 2 ** 31 - 7, 2 ** 31 - 6, 2 ** 31 - 5]],
                        device=cuda)
    before = dict(mc_noise.LAUNCHES)
    got = [tst.split(key), tst.split(key, 5), tst.fold_in(key, data), tst.fold_in(key, 3)]
    assert mc_noise.LAUNCHES["mc_fold_in"] - before["mc_fold_in"] == 4
    want = torch_path(lambda: [tst.split(key), tst.split(key, 5), tst.fold_in(key, data),
                               tst.fold_in(key, 3)])
    for g_keys, w_keys in zip(got[:2], want[:2]):
        assert len(g_keys) == len(w_keys)
        for gk, wk in zip(g_keys, w_keys):
            for a, b in zip(gk, wk):
                _same(a, b)
    for g_words, w_words in zip(got[2:], want[2:]):
        for a, b in zip(g_words, w_words):
            _same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("g", [0.0, 0.5, -0.3, 0.8, 0.99])
@pytest.mark.parametrize("n", [50, 885, 6302])
def test_rednoise_members_kernel_equals_the_torch_path(cuda, torch_path, dtype, g, n):
    """A chunk of surrogate rows through ``mc_rednoise`` and through the torch
    code, member indices from 0 and across 2^31, a ≠ 1, up to the long
    nulls' 6,302 samples."""
    key = tst.split(tst.PRNGKey(2 ** 31 + 977, device=cuda))[1]
    for start in (0, 2 ** 31 - 12):
        idx = start + torch.arange(24, device=cuda)
        rows = profiling.MC_KERNEL_ROWS, profiling.MC_PLAIN_ROWS
        got = tst.rednoise_members(key, idx, n, g, 1.7, dtype=dtype)
        assert (profiling.MC_KERNEL_ROWS - rows[0], profiling.MC_PLAIN_ROWS) == (24, rows[1])
        want = torch_path(lambda: tst.rednoise_members(key, idx, n, g, 1.7, dtype=dtype))
        assert profiling.MC_PLAIN_ROWS - rows[1] == 24
        _same(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("length", [1023, 1024, 1025, 885 + 9, 6302 + 199])
def test_rows_around_powers_of_two_equal_the_torch_path(cuda, torch_path, dtype, length):
    """Rows of n + tau values around a power of two (the scan's last step)
    and at the cell's and the long nulls' lengths."""
    key = tst.PRNGKey(11, device=cuda)
    idx = torch.arange(40, device=cuda)
    g = 0.8 if length != 6302 + 199 else 0.99
    tau = tst._burn_in(g)
    want = torch_path(lambda: tst.rednoise_members(key, idx, length - tau, g, dtype=dtype))
    _same(tst.rednoise_members(key, idx, length - tau, g, dtype=dtype), want)


def test_the_card_refuses_rows_the_kernel_does_not_draw(cuda):
    """On the card there is no other road: half-precision rows and |g| ≥ 1
    raise before any launch."""
    key = tst.PRNGKey(3, device=cuda)
    before = dict(mc_noise.LAUNCHES)
    with pytest.raises(TypeError, match="float32 or float64"):
        tst.rednoise_members(key, torch.arange(4, device=cuda), 30, 0.5, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\|g\| < 1"):
        tst.rednoise_members(key, torch.arange(4, device=cuda), 30, 2.0)
    assert mc_noise.LAUNCHES == before


def test_a_key_on_another_card_than_the_current(torch_path):
    """Keys and rows on cuda:1 while cuda:0 is current: each launch runs on
    the key's card, and equals the torch code there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA cards")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    key = tst.PRNGKey(2 ** 31 + 5, device=other)
    idx = torch.arange(300, device=other)
    got = [*tst.split(key)[1], tst.rednoise_members(key, idx, 885, 0.72)]
    want = torch_path(lambda: [*tst.split(key)[1],
                               tst.rednoise_members(key, idx, 885, 0.72)])
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, want):
        assert a.device == other
        _same(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("tau", [9, 199])
def test_rednoise_members_pairs_kernel_equals_the_torch_path(cuda, torch_path, dtype, tau):
    key = tst.PRNGKey(5, device=cuda)
    slots = torch.tensor([0, 5, 2 ** 31 - 1], device=cuda)
    g = torch.tensor([0.0, -0.45, 0.97], dtype=torch.float64, device=cuda)
    idx = 290 + torch.arange(17, device=cuda)
    got = tst.rednoise_members_pairs(key, slots, idx, 885, g, tau, dtype=dtype)
    want = torch_path(lambda: tst.rednoise_members_pairs(key, slots, idx, 885, g, tau,
                                                         dtype=dtype))
    _same(got, want)


def test_the_cells_chunk_equals_the_torch_path(cuda, torch_path):
    """One 300-member chunk at the ``wct_mc300`` shape (S 76, n 885, nfft
    1024, the cell's g range): the histogram and the curve through the
    kernels equal the torch path's, three generator launches a chunk, no
    row drawn by the torch code, and no host sync in the chunk."""
    n, sj, oc, _, _ = tco._surrogate_grid(JAO["dt"], JAO["dj"], JAO["s0"], JAO["J"],
                                          pt.Morlet(6))
    scales = torch.tensor(sj, dtype=torch.float32, device=cuda)
    oc = torch.tensor(oc, device=cuda)
    key = tst.PRNGKey(2 ** 31 + 4099, device=cuda)
    kw = dict(mother=pt.Morlet(6), nfft=1024, dj=JAO["dj"], n=n, al1=0.72, al2=0.41)
    # the torch path first: it also builds the chunk's cached operators
    want = torch_path(lambda: tco._mc_histogram_run(key, 0, scales, oc, JAO["dt"],
                                                    batch=300, nchunks=1, **kw))
    before, plain = dict(mc_noise.LAUNCHES), profiling.MC_PLAIN_ROWS
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tco._mc_histogram_run(key, 0, scales, oc, JAO["dt"], batch=300, nchunks=1, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: mc_noise.LAUNCHES[k] - before[k] for k in before} == {
        "mc_fold_in": 1, "mc_rednoise": 2}
    assert profiling.MC_PLAIN_ROWS == plain
    assert torch.equal(got, want)
    sig = dict(mc_count=300, seed=2 ** 31 + 4099, cache=False, progress=False, **JAO)
    curve = tco.wct_significance(0.72, 0.41, **sig)
    np.testing.assert_array_equal(curve, torch_path(
        lambda: tco.wct_significance(0.72, 0.41, **sig)))


def test_mc_bit_identical_across_mc_batch(cuda, route):
    """Curves and summed histograms at mc_batch 60, 16 and 7 (on K1+K2, or
    on cwt_direct under PYCWT_TPU_SMALL_KERNEL=1) are bit-identical."""
    n, sj, oc, _, _ = tco._surrogate_grid(JAO["dt"], JAO["dj"], JAO["s0"], JAO["J"],
                                          pt.Morlet(6))
    scales = torch.tensor(sj, dtype=torch.float32, device=cuda)
    oc = torch.tensor(oc, device=cuda)
    key = tst.PRNGKey(7, device=cuda)
    kw = dict(mother=pt.Morlet(6), nfft=1024, dj=JAO["dj"], n=n, al1=0.018, al2=0.085)
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0
    hists = [sum(tco._mc_histogram_chunk(key, s, scales, oc, JAO["dt"],
                                         batch=min(b, 60 - s), **kw)
                 for s in range(0, 60, b)) for b in (60, 16, 7)]
    for h in hists[1:]:
        assert torch.equal(h, hists[0])
    assert int(hists[0].sum()) == 60 * int(oc.sum())
    small = route == "1"
    assert (fc.KERNEL_LAUNCHES["cwt_direct"] > 0) == small
    assert (fc.KERNEL_LAUNCHES["cwt_stage_a"] > 0) == (not small)
    curves = [tco.wct_significance(0.018, 0.085, mc_count=60, mc_batch=b, seed=7,
                                   cache=False, progress=False, **JAO)
              for b in (60, 16, 7)]
    for c in curves[1:]:
        np.testing.assert_array_equal(c, curves[0])


def test_mc_batch_bit_identical_across_pair_block(cuda):
    kw = dict(mc_count=24, seed=3, cache=False, progress=False, **JAO)
    al1, al2 = [0.1, 0.3, 0.5, 0.7, 0.2], [0.2, 0.0, 0.6, 0.1, 0.4]
    a = tco.wct_significance_batch(al1, al2, pair_block=5, mc_batch=24, **kw)
    b = tco.wct_significance_batch(al1, al2, pair_block=2, mc_batch=7, **kw)
    np.testing.assert_array_equal(a, b)


def test_mc_f64_on_the_card_equals_the_cpu(cuda):
    """An f64 config on the card runs cuFFT in f64 ("xla") from the same
    streams: its curve is the CPU's."""
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=40, seed=4, cache=False,
              progress=False, mc_batch=16, config=CWTConfig(dtype=torch.float64))
    on_card = tco.wct_significance(0.5, 0.6, **kw)
    on_cpu = tco.wct_significance(0.5, 0.6, device="cpu", **kw)
    assert np.array_equal(np.isnan(on_card), np.isnan(on_cpu))
    assert np.nanmax(np.abs(on_card - on_cpu)) < 1e-9


def test_f64_config_runs_f64_on_the_card(cuda):
    """NINO3's |W| at the golden's 1e-10 with an f64 config and the default
    engine: no silent f32 kernels."""
    g = np.load(os.path.join(GOLDEN, "cwt_nino3_morlet6.npz"))
    for k in fc.KERNEL_LAUNCHES:
        fc.KERNEL_LAUNCHES[k] = 0
    W, *_ = pt.cwt(g["signal"], float(g["dt"]), config=CWTConfig(dtype=torch.float64))
    assert W.dtype == np.complex128
    assert _rel_err(W, g["W"]) < 1e-10
    power, *_ = pt.cwt_power(g["signal"], float(g["dt"]),
                             config=CWTConfig(dtype=torch.float64))
    assert _rel_err(power, np.abs(g["W"]) ** 2) < 1e-10
    assert sum(fc.KERNEL_LAUNCHES.values()) == 0
