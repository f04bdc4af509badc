"""Four gloo ranks on the CPU, mirroring ``tests/test_multihost.py`` and
``tests/multihost_worker.py``: the mc-sharded histogram's all-reduce, the
null-sharded batched MC against the single run, the broadcast from rank 0,
the (data=2 × scale=2) pipelines and the time-sharded and pencil surfaces
across ranks; and the multi-process cache semantics with a different cache
directory on every rank (rank 0's holds curves, the others' are empty), where
``wct_significance`` and ``wct_significance_batch(mesh=)`` must return the
same curves on every rank."""
import os
import warnings

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch.coherence import _sig_cache_name, _sig_cache_write
from pycwt_torch.config import CWTConfig
from pycwt_torch.parallel.sharded import pad_scales
from pycwt_torch.transform import cwt_batch

import test_torch_parallel_support as sup
from test_torch_parallel_support import CACHE_CASE, assemble

MOTHER = pt.Morlet(6)
F32 = CWTConfig(dtype=torch.float32)
#: batch pairs whose curves rank 0's cache holds
CACHED = (0, 2)


def _names(pairs):
    kw = CACHE_CASE["kw"]
    return [_sig_cache_name(a1, a2, kw["dj"], kw["s0"], kw["dt"], kw["J"], MOTHER,
                            kw["mc_count"], kw["seed"], F32, "cpu") for a1, a2 in pairs]


@pytest.fixture(scope="module")
def cache_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    dirs = [str(root / f"rank{r}") for r in range(4)]
    for d in dirs:
        os.makedirs(d)
    a1, a2 = CACHE_CASE["batch"]
    names = _names(zip(a1, a2))
    for p in CACHED:
        _sig_cache_write(os.path.join(dirs[0], names[p] + ".gz"),
                         sup.cached_curve(CACHE_CASE["kw"]["J"], p), F32, "cpu")
    return dirs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, cache_dirs):
    return sup.launch("multihost", 4, str(tmp_path_factory.mktemp("multihost")),
                      env_of_rank=lambda r: {"PYCWT_TPU_CACHE_DIR": cache_dirs[r]})


@pytest.fixture(scope="module")
def inputs():
    return sup.multihost_inputs()


def test_ranks_import_no_jax(ranks):
    assert all(bool(r["imports_clean"]) for r in ranks)
    assert [bool(r["is_coordinator"]) for r in ranks] == [True, False, False, False]


def test_mc_psum_total(ranks, inputs):
    grid, *_ = inputs
    oc = sup.mc_outsidecoi(grid.freqs, n=128)
    for r in ranks:
        assert int(r["mc/hist"].sum()) == 4 * oc.sum()
    assemble(ranks, "mc/hist")                    # replicated: every rank equal


def test_mc_pairs_shards_equal_single_run(ranks):
    """Each rank's slice of nulls equals the single-device run's rows."""
    sharded = assemble(ranks, "mc_pairs/sharded")
    for r in ranks:
        np.testing.assert_array_equal(sharded, r["mc_pairs/single"])
    assert sup.local_shapes(ranks, "mc_pairs/sharded") == {(1,) + sharded.shape[1:]}


def test_host_broadcast_array(ranks):
    assert [float(r["broadcast"][0]) for r in ranks] == [42.0] * 4


def test_power_pipeline_across_ranks(ranks, inputs):
    """(data=2 × scale=2): every shard equals the unsharded pipeline."""
    grid, nfft, X, *_ = inputs
    S = len(grid.sj)
    sj = grid.sj.astype(np.float32)
    Xn = torch.as_tensor((X - X.mean(1, keepdims=True)) / X.std(1, keepdims=True))
    W, _ = cwt_batch(Xn, torch.as_tensor(sj), 0.5, mother=MOTHER, nfft=nfft, config=F32)
    p = (W.abs() ** 2).numpy()
    np.testing.assert_allclose(assemble(ranks, "power/power")[:, :S], p, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(assemble(ranks, "power/gws")[:, :S], p.mean(-1),
                               rtol=2e-5, atol=1e-6)
    savg = (0.25 * 0.5 / MOTHER.cdelta) * (p / sj[None, :, None]).sum(1)
    np.testing.assert_allclose(assemble(ranks, "power/savg"), savg, rtol=2e-5, atol=1e-6)
    assert sup.local_shapes(ranks, "power/power") == {(2, pad_scales(sj, 2)[0].size // 2, 128)}


def test_wct_across_ranks(ranks, inputs):
    from pycwt_torch.coherence import _wct_core

    grid, nfft, X, Y, *_ = inputs
    S = len(grid.sj)
    R, A, _ = _wct_core(torch.as_tensor(X), torch.as_tensor(Y),
                        torch.as_tensor(grid.sj.astype(np.float32)), 0.5, mother=MOTHER,
                        nfft=nfft, dj=1 / 4)
    np.testing.assert_allclose(assemble(ranks, "wct/R")[:, :S], R.numpy(), rtol=2e-5,
                               atol=1e-6)
    dphi = np.angle(np.exp(1j * (assemble(ranks, "wct/A")[:, :S] - A.numpy())))
    assert np.abs(dphi[R.numpy() > 0.2]).max() < 1e-4


def test_overlap_and_pencil_across_ranks(ranks, inputs):
    from pycwt_torch.ops.overlap import cwt_overlap_save

    grid, _, _, _, xlong, xsp = inputs
    sj = grid.sj.astype(np.float32)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            Wl = cwt_overlap_save(xlong, sj[:8], 0.5, mother=MOTHER, chunk=128,
                                  device="cpu").numpy()
    finally:
        torch.set_default_dtype(prev)
    np.testing.assert_allclose(assemble(ranks, "overlap"), Wl, rtol=2e-5, atol=1e-6)
    ref = np.fft.fft(xsp.astype(np.float64))
    np.testing.assert_allclose(assemble(ranks, "pencil"), ref, rtol=0, atol=2e-2)
    W, _ = cwt_batch(torch.as_tensor(xsp)[None], torch.as_tensor(sj[:6]), 0.5,
                     mother=MOTHER, nfft=1024, config=F32)
    W = W[0].numpy()
    tol = 1e-5 * np.abs(W).max()
    np.testing.assert_allclose(assemble(ranks, "spectral"), W, rtol=0, atol=tol)
    np.testing.assert_allclose(assemble(ranks, "spectral_planar/re"), W.real, rtol=0, atol=tol)
    np.testing.assert_allclose(assemble(ranks, "spectral_planar/im"), W.imag, rtol=0, atol=tol)


def test_wct_significance_cache_on_coordinator_only(ranks):
    """Rank 0's cached curve is every rank's result: the others, whose
    caches are empty, neither read their own nor compute."""
    want = sup.cached_curve(CACHE_CASE["kw"]["J"], 0)
    for r in ranks:
        np.testing.assert_allclose(r["cache/single"], want, atol=1e-12)


@pytest.mark.parametrize("surface", ["cache/batch_mesh", "cache/batch"])
def test_wct_significance_batch_same_curves_on_every_rank(ranks, surface):
    """Rank 0 holds pairs 0 and 2; it broadcasts them and which pairs it
    holds before the deduplication, so every rank computes pair 1 alone and
    returns the same three curves (with mesh= the null is computed across
    the mc ranks)."""
    J = CACHE_CASE["kw"]["J"]
    first = ranks[0][surface]
    for p in CACHED:
        np.testing.assert_allclose(first[p], sup.cached_curve(J, p), atol=1e-12)
    for r in ranks:
        np.testing.assert_array_equal(r[surface], first)


def test_wct_significance_batch_mesh_computes_the_missing_null(ranks):
    """Pair 1, computed over the mesh, equals the single-device run of the
    same null, and rank 0 wrote it for the later call to read."""
    from pycwt_torch.coherence import wct_significance_batch

    a1, a2 = CACHE_CASE["batch"]
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = wct_significance_batch([a1[1]], [a2[1]], device="cpu", config=F32,
                                     cache=False, **{k: v for k, v in CACHE_CASE["kw"].items()})
    finally:
        torch.set_num_threads(prev)
    got = ranks[0]["cache/batch_mesh"][1]
    assert np.array_equal(np.isnan(got), np.isnan(ref[0]))
    np.testing.assert_allclose(got, ref[0], atol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(ranks[0]["cache/batch"], ranks[0]["cache/batch_mesh"])
