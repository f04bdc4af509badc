"""The sharded surfaces of ``pycwt_torch.parallel`` on 8 gloo ranks on the
CPU, against the port's unsharded functions (at ``tests/test_sharding.py``'s
and ``tests/test_overlap.py``'s bounds for sharded against single) and
against ``pycwt_tpu``'s sharded functions on the 8-device CPU mesh (at the
bounds the port's tests use for the unsharded counterparts).  One 8-rank job
(``test_torch_parallel_support.job_sharding``) serves every test."""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
from pycwt_tpu.parallel import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from pycwt_tpu.parallel import sharded as jsh

import pycwt_torch as pt
from pycwt_torch.ops.smoothing import rect_window, scale_boxcar_same, smooth
from pycwt_torch.parallel.sharded import pad_scales
from pycwt_torch.transform import build_scale_grid, cwt_batch, icwt_batch
from tests.conftest import rel_err

import test_torch_parallel_support as sup
from test_torch_parallel_support import DT, N0, SPECS_CWT, SPECS_WCT, assemble

MOTHER = pt.Morlet(6)
JMOTHER = wt.Morlet(6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return sup.launch("sharding", 8, str(tmp_path_factory.mktemp("sharding")))


@pytest.fixture(scope="module", autouse=True)
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.fixture(scope="module")
def workload():
    return sup.sharding_workload()


def _cwt(X, sj, nfft):
    W, _ = cwt_batch(torch.as_tensor(X), torch.as_tensor(sj), DT, mother=MOTHER, nfft=nfft)
    return W.numpy()


def _wct_ref(X, Y, sj, nfft, dj=1 / 8):
    from pycwt_torch.coherence import _wct_core

    R, A, W12 = _wct_core(torch.as_tensor(X), torch.as_tensor(Y), torch.as_tensor(sj),
                          DT, mother=MOTHER, nfft=nfft, dj=dj)
    return R.numpy(), A.numpy(), W12.numpy()


def test_ranks_import_no_jax(ranks):
    assert all(bool(r["imports_clean"]) for r in ranks)


@pytest.mark.parametrize("spec", SPECS_CWT, ids=sup.spec_name)
def test_sharded_cwt_matches_single_device(ranks, workload, spec):
    X, sj, _, nfft = workload
    S = len(sj)
    W = assemble(ranks, f"cwt/{sup.spec_name(spec)}")
    assert rel_err(W[:, :S], _cwt(X, sj, nfft)) < 1e-12
    B_loc, S_loc = 8 // spec[0], -(-S // spec[1])
    assert sup.local_shapes(ranks, f"cwt/{sup.spec_name(spec)}") == {(B_loc, S_loc, N0)}
    ft = assemble(ranks, f"cwt_ft/{sup.spec_name(spec)}")
    np.testing.assert_allclose(ft, np.fft.fft(X, n=nfft), atol=1e-12 * np.abs(ft).max())


def _jax_sharded_cwt(X, sj_pad, nfft, spec):
    """``pycwt_tpu``'s ``sharded_cwt`` with JAX's caches cleared before and
    after.  It jits ``cwt_batch`` with ``dt`` traced into that function's
    static argument, so a second trace on an equal mesh in one process
    compares two tracers for equality and raises.  Without the clearing, a
    worker that runs this file and ``tests/test_sharding.py`` (the same three
    meshes) fails whichever of them runs second."""
    jax.clear_caches()
    try:
        Wj, _ = jsh.sharded_cwt(jmake_mesh(JMeshSpec(*spec)), jnp.asarray(X),
                                jnp.asarray(sj_pad), DT, mother=JMOTHER, nfft=nfft)
        return np.asarray(Wj)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("spec", SPECS_CWT, ids=sup.spec_name)
def test_sharded_cwt_matches_jax(ranks, workload, spec):
    X, sj, _, nfft = workload
    sj_pad, S = pad_scales(sj, spec[1])
    Wj = _jax_sharded_cwt(X, sj_pad, nfft, spec)
    W = assemble(ranks, f"cwt/{sup.spec_name(spec)}")
    assert np.abs(W - Wj).max() < 1e-12 * np.abs(Wj).max()


@pytest.mark.parametrize("spec", SPECS_CWT, ids=sup.spec_name)
def test_jax_reference_leaves_sharded_cwt_callable(workload, spec):
    """After this file's JAX reference, ``pycwt_tpu``'s ``sharded_cwt`` on
    the same mesh runs again in this process, as ``tests/test_sharding.py``
    calls it, and gives the same transform."""
    X, sj, _, nfft = workload
    sj_pad, _ = pad_scales(sj, spec[1])
    first = _jax_sharded_cwt(X, sj_pad, nfft, spec)
    try:
        again, _ = jsh.sharded_cwt(jmake_mesh(JMeshSpec(*spec)), jnp.asarray(X),
                                   jnp.asarray(sj_pad), DT, mother=JMOTHER, nfft=nfft)
        np.testing.assert_array_equal(np.asarray(again), first)
    finally:
        jax.clear_caches()


def _power_refs(X, sj, nfft):
    Xn = (X - X.mean(1, keepdims=True)) / X.std(1, keepdims=True)
    W = _cwt(Xn, sj, nfft)
    p = np.abs(W) ** 2
    iw = icwt_batch(torch.as_tensor(W), torch.as_tensor(sj), DT, 1 / 8,
                    mother=MOTHER).numpy()
    savg = (DT / 8 / MOTHER.cdelta) * (p / sj[None, :, None]).sum(1)
    return p, p.mean(-1), iw, savg


def test_sharded_power_pipeline(ranks, workload):
    X, sj, _, nfft = workload
    S = len(sj)
    p, gws, iw, savg = _power_refs(X, sj, nfft)
    assert rel_err(assemble(ranks, "power/power")[:, :S], p) < 1e-11
    assert rel_err(assemble(ranks, "power/gws")[:, :S], gws) < 1e-11
    assert rel_err(assemble(ranks, "power/iw"), iw) < 1e-10
    assert rel_err(assemble(ranks, "power/savg"), savg) < 1e-10
    assert sup.local_shapes(ranks, "power/iw") == {(2, N0)}


def test_sharded_power_pipeline_matches_jax(ranks, workload):
    X, sj, _, nfft = workload
    sj_pad, S = pad_scales(sj, 2)
    outs = jsh.sharded_power_pipeline(
        jmake_mesh(JMeshSpec(data=4, scale=2)), jnp.asarray(X), jnp.asarray(sj_pad), DT,
        1 / 8, mother=JMOTHER, nfft=nfft, n_true_scales=S)
    for name, ref in zip(("power", "gws", "iw", "savg"), outs):
        ref = np.asarray(ref)
        got = assemble(ranks, f"power/{name}")
        assert np.abs(got - ref).max() < 1e-12 * np.abs(ref).max(), name


def test_sharded_wct_matches_host(ranks, workload):
    X, sj, _, nfft = workload
    Y = np.random.default_rng(1).standard_normal((8, N0))
    R_ref, _, _ = _wct_ref(X, Y, sj, nfft)
    assert rel_err(assemble(ranks, "wct/data8"), R_ref) < 1e-11
    Rj, _, _ = jsh.sharded_wct(jmake_mesh(JMeshSpec(data=8)), jnp.asarray(X),
                               jnp.asarray(Y), sj, DT, 1 / 8, mother=JMOTHER, nfft=nfft)
    assert np.abs(assemble(ranks, "wct/data8") - np.asarray(Rj)).max() < 1e-10


@pytest.mark.parametrize("spec", SPECS_WCT, ids=sup.spec_name)
def test_sharded_wct_scale_sharded_matches_host(ranks, workload, spec):
    """The scale-sharded WCT (halo exchange of the boxcar) equals the
    unsharded core on the true rows, the padded rows masked."""
    X, sj, _, nfft = workload
    S = len(sj)
    Y = np.random.default_rng(2).standard_normal((8, N0))
    R_ref, a_ref, W12_ref = _wct_ref(X, Y, sj, nfft)
    key = f"wct_scale/{sup.spec_name(spec)}"
    assert rel_err(assemble(ranks, key + "/R")[:, :S], R_ref) < 1e-11
    assert rel_err(assemble(ranks, key + "/W12")[:, :S], W12_ref) < 1e-11
    assert np.abs(assemble(ranks, key + "/A")[:, :S] - a_ref).max() < 1e-11


@pytest.mark.parametrize("spec", SPECS_WCT, ids=sup.spec_name)
def test_sharded_wct_scale_sharded_matches_jax(ranks, workload, spec):
    X, sj, _, nfft = workload
    Y = np.random.default_rng(2).standard_normal((8, N0))
    sj_pad, S = pad_scales(sj, spec[1])
    Rj, aj, Wj = jsh.sharded_wct(jmake_mesh(JMeshSpec(*spec)), jnp.asarray(X),
                                 jnp.asarray(Y), jnp.asarray(sj_pad), DT, 1 / 8,
                                 mother=JMOTHER, nfft=nfft, n_true_scales=S)
    key = f"wct_scale/{sup.spec_name(spec)}"
    assert np.abs(assemble(ranks, key + "/R")[:, :S] - np.asarray(Rj)[:, :S]).max() < 1e-10
    Wj = np.asarray(Wj)[:, :S]
    assert np.abs(assemble(ranks, key + "/W12")[:, :S] - Wj).max() < 1e-10 * np.abs(Wj).max()


def _jax_hist(mesh, key, sj, oc, pdb, nfft):
    return np.asarray(jsh.sharded_mc_histogram(
        mesh, key, jnp.asarray(sj), oc, DT, mother=JMOTHER, nfft=nfft, dj=1 / 8,
        per_device_batch=pdb, n=N0, al1=0.5, al2=0.6))


def test_sharded_mc_histogram_psum(ranks, workload):
    """8-way mc-sharded counts: (S, 1000), total = members × cells outside
    the COI, the same on every rank; and JAX's counts for the same members."""
    _, sj, freqs, nfft = workload
    oc = sup.mc_outsidecoi(freqs)
    hist = assemble(ranks, "mc/psum")
    assert hist.shape == (len(sj), 1000) and hist.dtype == np.int64
    assert hist.sum() == 8 * 2 * oc.sum()
    ref = _jax_hist(jmake_mesh(JMeshSpec(mc=8)), jax.random.PRNGKey(0), sj, oc, 2, nfft)
    assert ref.sum() == hist.sum()
    assert np.abs(hist - ref).sum() <= 2e-3 * hist.sum()


def test_mc_histogram_cross_mesh_determinism(ranks):
    """The same (seed, total count) gives bit-identical counts on an mc=8
    mesh, a data=4 × mc=2 mesh and the single-device chunks."""
    h8, h2 = assemble(ranks, "mc/h8"), assemble(ranks, "mc/h2")
    np.testing.assert_array_equal(h8, h2)
    for r in ranks:
        np.testing.assert_array_equal(h8, r["mc/host"])


def test_sharded_wct_pairs_equals_host(ranks):
    y1, y2 = sup.pairs_inputs()
    grid = build_scale_grid(256, 1.0, dj=1 / 6, mother=MOTHER)
    Wref, aref, _, _ = pt.wct_pairs(y1, y2, 1.0, dj=1 / 6, s0=grid.sj[0],
                                    J=len(grid.sj) - 1, device="cpu")
    np.testing.assert_allclose(assemble(ranks, "pairs/R"), Wref, rtol=0, atol=1e-10)
    np.testing.assert_allclose(assemble(ranks, "pairs/A"), aref, rtol=0, atol=1e-10)
    Wj, aj = jsh.sharded_wct_pairs(jmake_mesh(JMeshSpec(data=8)), y1, y2, grid.sj, 1.0,
                                   1 / 6, mother=JMOTHER, nfft=256)
    np.testing.assert_allclose(assemble(ranks, "pairs/R"), np.asarray(Wj), atol=1e-10)


def test_sharded_wct_matrix_equals_single_device(ranks, workload):
    """Pair-sharded all-pairs coherence (f32) == the port's wct_matrix and
    JAX's sharded matrix, 2 pairs a rank."""
    X, sj, _, nfft = workload
    pairs = sup.matrix_pairs()
    R_ref, a_ref, _, _, _ = pt.wct_matrix(X, DT, dj=1 / 8, pairs=pairs, device="cpu")
    assert sup.local_shapes(ranks, "matrix/R") == {(2, len(sj), N0)}
    np.testing.assert_allclose(assemble(ranks, "matrix/R"), R_ref, rtol=0, atol=5e-5)
    np.testing.assert_allclose(assemble(ranks, "matrix/A"), a_ref, rtol=0, atol=5e-5)
    Rj, _ = jsh.sharded_wct_matrix(
        jmake_mesh(JMeshSpec(data=8)), jnp.asarray(X, jnp.float32), pairs,
        jnp.asarray(sj, jnp.float32), DT, 1 / 8, mother=JMOTHER, nfft=nfft, block=2)
    np.testing.assert_allclose(assemble(ranks, "matrix/R"), np.asarray(Rj), atol=5e-5)


def test_sharded_wct_matrix_rejects_ragged_pairs(ranks):
    for r in ranks:
        assert "must be divisible by n_devices*block = 16" in str(r["matrix/ragged"])
        assert "pair indices out of range for B=8" in str(r["matrix/range"])


def test_sharded_mc_histogram_pairs_matches_single_device(ranks, workload):
    """The null-sharded batched MC over 8 ranks is bit-identical to the
    single-device run over the same slots; exactly 5 of the 6 members drawn
    count; JAX's sharded counts for the same members."""
    _, sj, freqs, nfft = workload
    oc = sup.mc_outsidecoi(freqs)
    sharded = assemble(ranks, "mc_pairs/sharded")
    assert sharded.shape == (8, len(sj), 1000)
    for r in ranks:
        np.testing.assert_array_equal(sharded, r["mc_pairs/single"])
    np.testing.assert_array_equal(sharded.sum(axis=(1, 2)), 5 * oc.sum())
    mp = sup.MC_PAIRS
    ref = np.asarray(jsh.sharded_mc_histogram_pairs(
        jmake_mesh(JMeshSpec(mc=8)), jax.random.PRNGKey(9), jnp.asarray(sj), oc,
        np.asarray(mp["slots"]), np.linspace(0.1, 0.8, 8), np.linspace(0.7, 0.05, 8),
        mp["mc_count"], DT, mother=JMOTHER, nfft=nfft, dj=1 / 8, batch=mp["batch"],
        nchunks=mp["nchunks"], n=N0, tau=mp["tau"]))
    assert np.abs(sharded - ref).sum() <= 2e-3 * sharded.sum()


def test_sharded_mc_histogram_pairs_rejects_indivisible(ranks):
    for r in ranks:
        assert "slots (3) must divide the 'mc' axis (8)" in str(r["mc_pairs/indivisible"])


def test_wct_significance_batch_mesh_equals_single_device(ranks):
    """mesh= spreads the distinct nulls over the mc ranks: bit-identical to
    the single-device run on every rank, and within 1e-9 of pycwt_tpu's."""
    from pycwt_tpu.coherence import wct_significance_batch as jbatch

    single = ranks[0]["sig_batch/single"]
    for r in ranks:
        np.testing.assert_array_equal(r["sig_batch/mesh"], single)
        np.testing.assert_array_equal(r["sig_batch/single"], single)
    sb = sup.SIG_BATCH
    ref = jbatch(sb["al1"], sb["al2"], mesh=jmake_mesh(JMeshSpec(mc=8)), **sb["kw"])
    assert np.array_equal(np.isnan(single), np.isnan(ref))
    assert np.nanmax(np.abs(single - ref)) < 1e-9


def test_sharded_overlap_save_matches_single_device(ranks):
    """Time-sharded overlap-save == the single-device chunk loop, same
    chunking and zero-pad edges; the (S, N) map is never on one rank."""
    from pycwt_tpu.ops.overlap import sharded_cwt_overlap_save as jov
    from pycwt_torch.ops.overlap import cwt_overlap_save

    x, sj, *_ = sup.overlap_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W1 = cwt_overlap_save(x, sj, 1.0, mother=MOTHER, chunk=512, device="cpu").numpy()
        Wj = np.asarray(jov(jmake_mesh(JMeshSpec(data=8)), x, sj, 1.0, mother=JMOTHER,
                            chunk=512))
    W = assemble(ranks, "overlap/W")
    assert W.shape == W1.shape
    assert sup.local_shapes(ranks, "overlap/W") == {(len(sj), 1024)}
    np.testing.assert_allclose(W, W1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(W, Wj, rtol=0, atol=1e-12)


def test_sharded_overlap_save_validations(ranks):
    for r in ranks:
        assert "local slab 125 not a multiple of chunk 512" in str(r["overlap/indivisible"])
        assert ("N=1001 not divisible by 8 devices (pass auto_pad=True to zero-pad)"
                in str(r["overlap/indivisible_n"]))
        assert "exceeds local slab 64" in str(r["overlap/halo"])


def test_sharded_overlap_save_auto_pad(ranks):
    """auto_pad zero-pads 5000 samples to 8·512·2, computes and trims; the
    trimmed map is replicated and equals the single-device loop."""
    from pycwt_torch.ops.overlap import cwt_overlap_save

    _, _, xp, sjp, *_ = sup.overlap_inputs()
    W = assemble(ranks, "overlap/auto_pad")
    assert W.shape == (len(sjp), 5000)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        W1 = cwt_overlap_save(np.pad(xp, (0, 8 * 512 * 2 - 5000)), sjp, 1.0,
                              mother=MOTHER, chunk=512, device="cpu").numpy()[:, :5000]
    np.testing.assert_allclose(W, W1, rtol=0, atol=1e-12)


def test_sharded_wct_overlap_matches_single_device(ranks):
    from pycwt_tpu.ops.overlap import sharded_wct_overlap_planar as jwov
    from pycwt_torch.ops.overlap import wct_overlap_planar

    *_, y1, y2, sj = sup.overlap_inputs()
    R1, A1 = wct_overlap_planar(y1, y2, sj, 1.0, mother=MOTHER, dj=0.5, chunk=1024,
                                device="cpu")
    R1, A1 = R1.numpy(), A1.numpy()
    Rs, As = assemble(ranks, "wct_overlap/R"), assemble(ranks, "wct_overlap/A")
    np.testing.assert_allclose(Rs, R1, rtol=0, atol=1e-5)
    dphi = np.angle(np.exp(1j * (As - A1)))
    assert np.abs(dphi[R1 > 0.2]).max() < 1e-4
    Rj, _ = jwov(jmake_mesh(JMeshSpec(data=8)), y1, y2, jnp.asarray(sj), 1.0,
                 mother=JMOTHER, dj=0.5, chunk=1024)
    # the port's bound for wct_overlap_planar against pycwt_tpu's
    # (tests/test_torch_overlap.py)
    np.testing.assert_allclose(Rs, np.asarray(Rj), rtol=0, atol=2e-4)


def test_sharded_wct_overlap_validates(ranks):
    for r in ranks:
        assert "N=1001 not divisible by 8 devices" in str(r["wct_overlap/indivisible"])


def test_scale_boxcar_sharded_padded_rows(ranks):
    """Blocks of 3 rows on 8 scale ranks, the rows past the true 21 zero:
    the halo boxcar equals the unsharded 'same' boxcar on the true rows."""
    T, _, S = sup.smoothing_inputs()
    ref = scale_boxcar_same(torch.as_tensor(T[:, :S]), rect_window(5)).numpy()
    got = np.concatenate([r["smooth/boxcar"] for r in ranks], axis=1)[:, :S]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


def test_smooth_scale_sharded_masks_padded_rows(ranks):
    """Garbage rows past n_true_scales are zeroed before the boxcar: the
    sharded smoothing equals smooth() of the true rows."""
    T, sj, S = sup.smoothing_inputs()
    ref = smooth(torch.as_tensor(T[:, :S]), 1.0, 0.25, torch.as_tensor(sj[:S]),
                 MOTHER).numpy()
    got = np.concatenate([r["smooth/full"] for r in ranks], axis=1)[:, :S]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_scale_boxcar_sharded_halo_error(ranks):
    """A 10-tap boxcar needs 5 rows of halo, more than a 3-row block: every
    rank raises, and sharded_wct raises the same before any collective."""
    for r in ranks:
        assert "boxcar halo 5 exceeds local scale block 3" in str(r["smooth/halo"])
        assert "boxcar halo 14 exceeds local scale block 8" in str(r["wct_scale/halo"])


def test_make_mesh_layouts(ranks):
    """A spec must cover the world, and ``devices`` may only list its ranks
    in order (a process group numbers a dim's ranks so)."""
    for rank, r in enumerate(ranks):
        assert "mesh spec MeshSpec(data=3, scale=1, mc=1) needs 3 devices, have 8" in str(
            r["mesh/size"])
        assert "devices must be the 8 ranks of the world in order" in str(r["mesh/ranks"])
        assert int(r["mesh/in_order"]) == rank


def test_refused_calls_leave_no_rank_waiting(ranks):
    """After every refused call each rank still reached the next collective."""
    assert [float(r["after_errors"]) for r in ranks] == [8.0] * 8


def test_dryrun_multichip(ranks):
    """The port's dryrun_multichip(8): every sharded result equal to the
    unsharded run on every rank."""
    assert all(bool(r["dryrun/ok"]) for r in ranks)
