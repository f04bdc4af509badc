"""Rank-side scenarios of ``pycwt_torch.parallel``, shared by the CPU tests
(``tests/test_torch_{sharding,dist_fft,multihost}.py``) and
``chip_smoke.py``'s ``phase_parallel``.  Imports no JAX.

Run as a script, this file is one rank of a job::

    python tests/test_torch_parallel_support.py JOB RANK WORLD INIT OUT DEVICE BACKEND

which starts the process group (``INIT`` a ``file://`` or ``tcp://`` URL),
checks that neither ``jax`` nor ``pycwt_tpu`` was imported, runs the job's
scenarios and writes ``OUT/rank{RANK}.npz``: each sharded result's local
block with its global offset and shape (:class:`Recorder`), which
:func:`assemble` joins again.  :func:`launch` starts the ranks of a job,
bounded by a timeout after which every rank is killed.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# --------------------------------------------------------------------------
# Results of a rank, and their assembly
# --------------------------------------------------------------------------

class Recorder:
    """Named arrays of one rank: plain host arrays, DTensor blocks (with
    their global offset and shape) and the messages of expected errors."""

    def __init__(self):
        self.arrays: dict[str, np.ndarray] = {}

    def put(self, name: str, value) -> None:
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.arrays[name] = np.asarray(value)

    def put_dt(self, name: str, dt) -> None:
        local = dt.to_local()
        coord = dt.device_mesh.get_coordinate()
        offset = [0] * dt.ndim
        for i, p in enumerate(dt.placements):
            if p.is_shard():
                offset[p.dim] += coord[i] * local.shape[p.dim]
        self.put(name, local)
        self.arrays[name + "@offset"] = np.asarray(offset, np.int64)
        self.arrays[name + "@shape"] = np.asarray(dt.shape, np.int64)

    def put_error(self, name: str, call) -> None:
        """Run ``call``, which must raise ``ValueError``, and keep its message."""
        try:
            call()
        except ValueError as e:
            self.arrays[name] = np.asarray(str(e))
        else:
            self.arrays[name] = np.asarray("<no error>")

    def save(self, path: str) -> None:
        np.savez(path, **self.arrays)


def assemble(results: list[dict], name: str) -> np.ndarray:
    """The global array of a DTensor result from every rank's block;
    replicated blocks must agree bit for bit and every element must be
    covered."""
    shape = tuple(results[0][name + "@shape"])
    first = results[0][name]
    full = np.zeros(shape, first.dtype)
    seen = np.zeros(shape, bool)
    for res in results:
        local, off = res[name], res[name + "@offset"]
        sl = tuple(slice(o, o + n) for o, n in zip(off, local.shape))
        if seen[sl].any():
            np.testing.assert_array_equal(full[sl][seen[sl]], local[seen[sl]],
                                          err_msg=f"{name}: replicas differ")
        full[sl] = local
        seen[sl] = True
    assert seen.all(), f"{name}: blocks do not cover the array"
    return full


def local_shapes(results: list[dict], name: str) -> set:
    return {tuple(res[name].shape) for res in results}


def launch(job: str, world: int, tmp_dir: str, *, timeout: float = 300,
           env_of_rank=None) -> list[dict]:
    """Run ``world`` ranks of ``job`` on the CPU (gloo, a ``file://``
    rendezvous in ``tmp_dir``) and return each rank's results.  A rank that
    fails, or a job that outlives ``timeout`` (every rank is then killed
    by PID), fails the calling test."""
    out = os.path.join(tmp_dir, f"{job}-out")
    os.makedirs(out, exist_ok=True)
    init = "file://" + os.path.join(tmp_dir, f"{job}-rendezvous")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        renv = dict(env, **(env_of_rank(r) if env_of_rank else {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r), str(world), init,
             out, "cpu", "gloo"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=renv, cwd=REPO))
    logs = [""] * world
    try:
        for r, p in enumerate(procs):
            logs[r], _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{job}: ranks timed out after {timeout} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{job} rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]


# --------------------------------------------------------------------------
# Inputs (seeded numpy), shared with the pytest side
# --------------------------------------------------------------------------

N0, DT = 256, 0.5
SPECS_CWT = [(8, 1, 1), (4, 2, 1), (2, 2, 2)]
SPECS_WCT = [(2, 4, 1), (4, 2, 1), (1, 8, 1)]
MC_PAIRS = dict(slots=[11, 5003, 7, 123457, 42, 9999, 31337, 2],
                batch=3, nchunks=2, tau=64, mc_count=5)
SIG_BATCH = dict(al1=[0.2, 0.45, 0.6, 0.7, 0.15], al2=[0.3, 0.5, 0.25, 0.6, 0.4],
                 kw=dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=10,
                         progress=False, cache=False, seed=4))


def spec_name(spec) -> str:
    return "x".join(map(str, spec))


def sharding_workload():
    """``tests/test_sharding.py``'s: 8 signals of 256 samples, dt 0.5,
    Morlet-6, dj 1/8; returns ``(X, sj, freqs, nfft)``."""
    from pycwt_torch.config import DEFAULT
    from pycwt_torch.transform import build_scale_grid

    X = np.random.default_rng(0).standard_normal((8, N0))
    grid = build_scale_grid(N0, DT, dj=1 / 8)
    return X, grid.sj, grid.freqs, DEFAULT.fft_length(N0)


def mc_outsidecoi(freqs, n=N0, top=20.0):
    coi = np.linspace(0, top, n)
    return (1.0 / freqs)[:, None] <= coi[None, :]


def smoothing_inputs():
    """A (2, 21, 16) field padded to 24 scale rows with garbage rows, and
    its scales (dj 1/8: a 10-tap boxcar on 8 ranks of 3 rows raises; 5
    taps fit)."""
    rng = np.random.default_rng(3)
    T = rng.standard_normal((2, 24, 16)) + 1j * rng.standard_normal((2, 24, 16))
    sj = 2.0 * 2 ** (np.arange(24) / 8)
    return T, sj, 21


def overlap_inputs():
    """``tests/test_overlap.py``'s sharded cases."""
    from pycwt_torch.transform import build_scale_grid

    x = np.random.default_rng(4).standard_normal(8192)
    sj = build_scale_grid(8192, 1.0, dj=0.5, s0=2.0, J=8).sj
    xp = np.random.default_rng(7).standard_normal(5000)
    sjp = build_scale_grid(5000, 1.0, dj=0.5, s0=2.0, J=6).sj
    rng = np.random.default_rng(31)
    y1 = rng.standard_normal(8 * 1024).astype(np.float32)
    y2 = (0.5 * y1 + rng.standard_normal(8 * 1024)).astype(np.float32)
    return x, sj, xp, sjp, y1, y2, np.asarray([8.0, 16.0, 32.0], np.float32)


def pairs_inputs():
    rng = np.random.default_rng(17)
    y1 = rng.standard_normal((8, 256))
    return y1, 0.5 * y1 + rng.standard_normal((8, 256))


def matrix_pairs(B=8):
    return np.array([(i, (i + k) % B) for k in (1, 2) for i in range(B)], np.int32)


def dist_fft_inputs():
    """Every input of the pencil-FFT cases, by name."""
    out = {}
    for N in (1 << 8, 1 << 10, 1 << 13):
        out[f"real{N}"] = np.random.default_rng(0).standard_normal(N)
    rng = np.random.default_rng(1)
    out["complex"] = rng.standard_normal(1 << 10) + 1j * rng.standard_normal(1 << 10)
    out["roundtrip"] = np.random.default_rng(2).standard_normal(1 << 10)
    out["layout"] = np.random.default_rng(3).standard_normal(1 << 10)
    out["f32"] = np.random.default_rng(4).standard_normal(1 << 10).astype(np.float32)
    out["spectral"] = np.random.default_rng(7).standard_normal(1 << 11)
    out["spectral_layout"] = np.random.default_rng(8).standard_normal(1 << 10)
    rng = np.random.default_rng(9)
    out["planar_re"] = rng.standard_normal(1 << 10)
    out["planar_im"] = rng.standard_normal(1 << 10)
    out["planar_layout"] = np.random.default_rng(10).standard_normal(1 << 10)
    out["spectral_planar"] = np.random.default_rng(11).standard_normal(1 << 11)
    return out


def spectral_scales(dt, mother, which):
    s_min = 2 * dt / mother.flambda()
    if which == "exact":
        return np.asarray([s_min, 2.0, 7.3, 64.0, 256.0])
    return np.asarray([s_min, 2.0, 16.0, 128.0])


def multihost_inputs():
    """``tests/multihost_worker.py``'s: 128 samples, dt 0.5, dj 1/4, f32."""
    from pycwt_torch.config import DEFAULT
    from pycwt_torch.transform import build_scale_grid

    grid = build_scale_grid(128, 0.5, dj=1 / 4)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((4, 128)).astype(np.float32)
    Y = rng.standard_normal((4, 128)).astype(np.float32)
    xlong = rng.standard_normal(4 * 256).astype(np.float32)
    xsp = rng.standard_normal(1 << 10).astype(np.float32)
    return grid, DEFAULT.fft_length(128), X, Y, xlong, xsp


#: ranks whose cache directories differ: (al1, al2) of the single-pair call
#: and of the batch whose cached curves only rank 0's cache directory holds
CACHE_CASE = dict(kw=dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=8, seed=3,
                          progress=False),
                  single=(0.3, 0.4), batch=([0.3, 0.5, 0.2], [0.4, 0.1, 0.6]))


def cached_curve(J: int, p: int) -> np.ndarray:
    """The recognizable curve rank 0's cache holds for pair ``p``."""
    return np.linspace(0.11, 0.91, J + 1) + 0.01 * p


# --------------------------------------------------------------------------
# Jobs (rank side)
# --------------------------------------------------------------------------

def _barrier_sum(mesh) -> float:
    """A collective after a refused call: every rank must still reach it."""
    from pycwt_torch.parallel._collectives import psum

    return float(psum(torch.ones(1, dtype=torch.float64), mesh, "data"))


def job_sharding(rec: Recorder, world: int) -> None:
    """``tests/test_sharding.py``, the sharded cases of
    ``tests/test_overlap.py`` and the sharded smoothing, on 8 ranks."""
    import pycwt_torch as pt
    from pycwt_torch.coherence import _mc_histogram_chunk, wct_significance_batch
    from pycwt_torch.ops.overlap import (sharded_cwt_overlap_save,
                                         sharded_wct_overlap_planar)
    from pycwt_torch.ops.smoothing import (rect_window, scale_boxcar_same_sharded,
                                           smooth_scale_sharded)
    from pycwt_torch.parallel import (MeshSpec, make_mesh, sharded_cwt,
                                      sharded_mc_histogram, sharded_mc_histogram_pairs,
                                      sharded_power_pipeline, sharded_wct,
                                      sharded_wct_matrix, sharded_wct_pairs)
    from pycwt_torch.parallel._collectives import axis_rank
    from pycwt_torch.parallel.sharded import pad_scales
    from pycwt_torch.stats import PRNGKey
    from pycwt_torch.transform import build_scale_grid

    mother = pt.Morlet(6)
    X, sj, freqs, nfft = sharding_workload()
    mesh8 = make_mesh(MeshSpec(data=8))
    for spec in SPECS_CWT:
        mesh = make_mesh(MeshSpec(*spec))
        sj_pad, _ = pad_scales(sj, spec[1])
        W, ft = sharded_cwt(mesh, X, sj_pad, DT, mother=mother, nfft=nfft)
        rec.put_dt(f"cwt/{spec_name(spec)}", W)
        rec.put_dt(f"cwt_ft/{spec_name(spec)}", ft)

    mesh42 = make_mesh(MeshSpec(data=4, scale=2))
    sj_pad, S = pad_scales(sj, 2)
    outs = sharded_power_pipeline(mesh42, X, sj_pad, DT, 1 / 8, mother=mother,
                                  nfft=nfft, n_true_scales=S)
    for name, o in zip(("power", "gws", "iw", "savg"), outs):
        rec.put_dt(f"power/{name}", o)

    Y = np.random.default_rng(1).standard_normal((8, N0))
    R, _, _ = sharded_wct(mesh8, X, Y, sj, DT, 1 / 8, mother=mother, nfft=nfft)
    rec.put_dt("wct/data8", R)
    Y2 = np.random.default_rng(2).standard_normal((8, N0))
    for spec in SPECS_WCT:
        mesh = make_mesh(MeshSpec(*spec))
        sj_pad, S = pad_scales(sj, spec[1])
        R, A, W12 = sharded_wct(mesh, X, Y2, sj_pad, DT, 1 / 8, mother=mother,
                                nfft=nfft, n_true_scales=S)
        for name, o in (("R", R), ("A", A), ("W12", W12)):
            rec.put_dt(f"wct_scale/{spec_name(spec)}/{name}", o)

    oc = mc_outsidecoi(freqs)
    kw = dict(mother=mother, nfft=nfft, dj=1 / 8, n=N0, al1=0.5, al2=0.6)
    mc8 = make_mesh(MeshSpec(mc=8))
    rec.put_dt("mc/psum", sharded_mc_histogram(mc8, PRNGKey(0), sj, oc, DT,
                                               per_device_batch=2, **kw))
    rec.put_dt("mc/h8", sharded_mc_histogram(mc8, PRNGKey(5), sj, oc, DT,
                                             per_device_batch=2, **kw))
    rec.put_dt("mc/h2", sharded_mc_histogram(make_mesh(MeshSpec(data=4, mc=2)), PRNGKey(5),
                                             sj, oc, DT, per_device_batch=8, **kw))
    sc = torch.as_tensor(sj)
    rec.put("mc/host", sum(_mc_histogram_chunk(
        PRNGKey(5), start, sc, torch.as_tensor(oc), DT, batch=8, **kw) for start in (0, 8)))

    y1, y2 = pairs_inputs()
    grid2 = build_scale_grid(256, 1.0, dj=1 / 6, mother=mother)
    Wp, ap = sharded_wct_pairs(mesh8, y1, y2, grid2.sj, 1.0, 1 / 6, mother=mother, nfft=256)
    rec.put_dt("pairs/R", Wp)
    rec.put_dt("pairs/A", ap)

    Xf = torch.as_tensor(X, dtype=torch.float32)
    sjf = torch.as_tensor(sj, dtype=torch.float32)
    Rm, am = sharded_wct_matrix(mesh8, Xf, matrix_pairs(), sjf, DT, 1 / 8,
                                mother=mother, nfft=nfft, block=2)
    rec.put_dt("matrix/R", Rm)
    rec.put_dt("matrix/A", am)
    rec.put_error("matrix/ragged", lambda: sharded_wct_matrix(
        mesh8, Xf, np.zeros((10, 2), np.int32), sjf, DT, 1 / 8, mother=mother,
        nfft=nfft, block=2))
    rec.put_error("matrix/range", lambda: sharded_wct_matrix(
        mesh8, Xf, np.full((16, 2), 8, np.int32), sjf, DT, 1 / 8, mother=mother,
        nfft=nfft, block=2))

    mp = MC_PAIRS
    g1, g2 = np.linspace(0.1, 0.8, 8), np.linspace(0.7, 0.05, 8)
    pk = dict(mother=mother, nfft=nfft, dj=1 / 8, batch=mp["batch"],
              nchunks=mp["nchunks"], n=N0, tau=mp["tau"])
    rec.put_dt("mc_pairs/sharded", sharded_mc_histogram_pairs(
        mc8, PRNGKey(9), sj, oc, mp["slots"], g1, g2, mp["mc_count"], DT, **pk))
    from pycwt_torch.coherence import _mc_histogram_run_pairs
    rec.put("mc_pairs/single", _mc_histogram_run_pairs(
        PRNGKey(9), sc, torch.as_tensor(oc), torch.as_tensor(mp["slots"]),
        torch.as_tensor(g1), torch.as_tensor(g2), mp["mc_count"], DT, **pk))
    rec.put_error("mc_pairs/indivisible", lambda: sharded_mc_histogram_pairs(
        mc8, PRNGKey(0), np.zeros(4), np.ones((4, 8), bool), np.arange(3),
        np.zeros(3), np.zeros(3), 5, 1.0, mother=mother, nfft=8, dj=0.25, batch=2,
        nchunks=1, n=8, tau=0))
    sb = SIG_BATCH
    rec.put("sig_batch/single", wct_significance_batch(
        sb["al1"], sb["al2"], mc_batch=5, device="cpu", **sb["kw"]))
    rec.put("sig_batch/mesh", wct_significance_batch(sb["al1"], sb["al2"], mesh=mc8,
                                                     **sb["kw"]))

    x, sjo, xp, sjp, o1, o2, sjw = overlap_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the near-Nyquist caveat
        rec.put_dt("overlap/W", sharded_cwt_overlap_save(mesh8, x, sjo, 1.0, mother=mother,
                                                         chunk=512))
        rec.put_error("overlap/indivisible", lambda: sharded_cwt_overlap_save(
            mesh8, np.zeros(1000), build_scale_grid(1000, 1.0, dj=0.5, s0=2.0, J=4).sj,
            1.0, mother=mother, chunk=512))
        rec.put_error("overlap/indivisible_n", lambda: sharded_cwt_overlap_save(
            mesh8, np.zeros(1001), sjo, 1.0, mother=mother, chunk=512))
        rec.put_error("overlap/halo", lambda: sharded_cwt_overlap_save(
            mesh8, np.zeros(8 * 64), sjo, 1.0, mother=mother, chunk=64))
        rec.put_dt("overlap/auto_pad", sharded_cwt_overlap_save(
            mesh8, xp, sjp, 1.0, mother=mother, chunk=512, auto_pad=True))
    R, A = sharded_wct_overlap_planar(mesh8, o1, o2, sjw, 1.0, mother=mother, dj=0.5,
                                      chunk=1024)
    rec.put_dt("wct_overlap/R", R)
    rec.put_dt("wct_overlap/A", A)
    rec.put_error("wct_overlap/indivisible", lambda: sharded_wct_overlap_planar(
        mesh8, np.zeros(1001), np.zeros(1001), np.asarray([8.0]), 1.0, mother=mother,
        dj=0.5))

    T, sjs, S_true = smoothing_inputs()
    scale8 = make_mesh(MeshSpec(scale=8))
    r = axis_rank(scale8, "scale")
    Tz = T.copy()
    Tz[:, S_true:] = 0
    win = rect_window(5)
    rec.put("smooth/boxcar", scale_boxcar_same_sharded(
        torch.as_tensor(Tz[:, 3 * r:3 * r + 3]), win, mesh=scale8))
    rec.put("smooth/full", smooth_scale_sharded(
        torch.as_tensor(T[:, 3 * r:3 * r + 3]), 1.0, 0.25, torch.as_tensor(sjs[3 * r:3 * r + 3]),
        mother, n_true_scales=S_true, mesh=scale8))
    rec.put_error("smooth/halo", lambda: scale_boxcar_same_sharded(
        torch.as_tensor(T[:, 3 * r:3 * r + 3]), rect_window(10), mesh=scale8))
    rec.put_error("wct_scale/halo", lambda: sharded_wct(
        scale8, X, Y2, pad_scales(sj, 8)[0], DT, 1 / 24, mother=mother, nfft=nfft))
    rec.put_error("mesh/size", lambda: make_mesh(MeshSpec(data=3)))
    rec.put_error("mesh/ranks", lambda: make_mesh(MeshSpec(data=8),
                                                  devices=list(range(7, -1, -1))))
    rec.put("mesh/in_order", axis_rank(make_mesh(MeshSpec(data=8), devices=range(8)),
                                       "data"))
    rec.put("after_errors", _barrier_sum(mesh8))
    dryrun_multichip(rec, world)


def job_dist_fft(rec: Recorder, world: int) -> None:
    """``tests/test_dist_fft.py``'s cases on 8 ranks (data=8)."""
    import pycwt_torch as pt
    from pycwt_torch.parallel import (MeshSpec, make_mesh, sharded_cwt_spectral,
                                      sharded_cwt_spectral_planar, sharded_dft,
                                      sharded_dft_planar, sharded_idft)

    mesh = make_mesh(MeshSpec(data=8))
    inp = dist_fft_inputs()
    for N in (1 << 8, 1 << 10, 1 << 13):
        rec.put_dt(f"dft/real{N}", sharded_dft(mesh, inp[f"real{N}"]))
    rec.put_dt("dft/complex", sharded_dft(mesh, inp["complex"]))
    X = sharded_dft(mesh, inp["roundtrip"])
    rec.put_dt("dft/roundtrip", sharded_idft(mesh, X))
    rec.put_dt("dft/layout", sharded_dft(mesh, inp["layout"]))
    rec.put_dt("dft/f32", sharded_dft(mesh, inp["f32"]))
    rec.put_error("dft/non_pow2", lambda: sharded_dft(mesh, np.zeros(1000)))
    rec.put_error("dft/too_small", lambda: sharded_dft(mesh, np.zeros(32)))
    mother = pt.Morlet(6)
    rec.put_dt("spectral/exact", sharded_cwt_spectral(
        mesh, inp["spectral"], spectral_scales(1.0, mother, "exact"), 1.0, mother=mother))
    rec.put_dt("spectral/layout", sharded_cwt_spectral(
        mesh, inp["spectral_layout"], np.asarray([4.0, 16.0]), 1.0, mother=mother))
    Xr, Xi = sharded_dft_planar(mesh, inp["planar_re"])
    rec.put_dt("planar/real_re", Xr)
    rec.put_dt("planar/real_im", Xi)
    Xr, Xi = sharded_dft_planar(mesh, inp["planar_re"], inp["planar_im"])
    rec.put_dt("planar/complex_re", Xr)
    rec.put_dt("planar/complex_im", Xi)
    Xr, Xi = sharded_dft_planar(mesh, inp["planar_layout"])
    rec.put_dt("planar/layout_re", Xr)
    rec.put_dt("planar/layout_im", Xi)
    sc = spectral_scales(0.5, mother, "planar")
    rec.put_dt("spectral_planar/complex", sharded_cwt_spectral(
        mesh, inp["spectral_planar"], sc, 0.5, mother=mother))
    wr, wi = sharded_cwt_spectral_planar(mesh, inp["spectral_planar"], sc, 0.5, mother=mother)
    rec.put_dt("spectral_planar/re", wr)
    rec.put_dt("spectral_planar/im", wi)
    wr, wi = sharded_cwt_spectral_planar(mesh, np.zeros(1 << 10, np.float32),
                                         np.asarray([4.0, 16.0], np.float32), 1.0,
                                         mother=mother)
    rec.put("spectral_planar/dtypes", np.asarray(
        [str(t.dtype) for t in (wr, wi, wr.to_local(), wi.to_local())]))
    rec.put("after_errors", _barrier_sum(mesh))


def job_multihost(rec: Recorder, world: int) -> None:
    """``tests/multihost_worker.py`` on 4 ranks, and ranks whose cache
    directories differ (rank 0's holds the curves)."""
    import pycwt_torch as pt
    from pycwt_torch.coherence import (_mc_histogram_run_pairs, wct_significance,
                                       wct_significance_batch)
    from pycwt_torch.ops.overlap import sharded_cwt_overlap_save
    from pycwt_torch.parallel import (MeshSpec, make_mesh, sharded_cwt_spectral,
                                      sharded_cwt_spectral_planar, sharded_dft,
                                      sharded_mc_histogram, sharded_mc_histogram_pairs,
                                      sharded_power_pipeline, sharded_wct)
    from pycwt_torch.parallel.distributed import host_broadcast_array, is_coordinator
    from pycwt_torch.parallel.sharded import pad_scales
    from pycwt_torch.stats import PRNGKey

    import torch.distributed as dist

    grid, nfft, X, Y, xlong, xsp = multihost_inputs()
    mother = pt.Morlet(6)
    rank = dist.get_rank()
    rec.put("is_coordinator", is_coordinator())
    mesh = make_mesh(MeshSpec(mc=4))
    oc = mc_outsidecoi(grid.freqs, n=128)
    sj32 = grid.sj.astype(np.float32)
    rec.put_dt("mc/hist", sharded_mc_histogram(
        mesh, PRNGKey(0), sj32, oc, 0.5, mother=mother, nfft=nfft, dj=1 / 4,
        per_device_batch=1, n=128, al1=0.5, al2=0.5))
    slots = np.asarray([17, 4242, 99991, 7], np.int64)
    g1 = np.asarray([0.2, 0.5, 0.65, 0.1], np.float32)
    g2 = np.asarray([0.4, 0.3, 0.15, 0.6], np.float32)
    pk = dict(mother=mother, nfft=nfft, dj=1 / 4, batch=2, nchunks=2, n=128, tau=32)
    rec.put_dt("mc_pairs/sharded", sharded_mc_histogram_pairs(
        mesh, PRNGKey(3), sj32, oc, slots, g1, g2, 3, 0.5, **pk))
    rec.put("mc_pairs/single", _mc_histogram_run_pairs(
        PRNGKey(3), torch.as_tensor(sj32), torch.as_tensor(oc), torch.as_tensor(slots),
        torch.as_tensor(g1), torch.as_tensor(g2), 3, 0.5, **pk))
    rec.put("broadcast", host_broadcast_array(
        np.array([42.0 + rank]) if rank == 0 else np.array([-1.0])))

    mesh22 = make_mesh(MeshSpec(data=2, scale=2))
    sj_pad, S = pad_scales(sj32, 2)
    outs = sharded_power_pipeline(mesh22, X, sj_pad, 0.5, 1 / 4, mother=mother,
                                  nfft=nfft, n_true_scales=S)
    for name, o in zip(("power", "gws", "iw", "savg"), outs):
        rec.put_dt(f"power/{name}", o)
    R, A, _ = sharded_wct(mesh22, X, Y, sj_pad, 0.5, 1 / 4, mother=mother, nfft=nfft,
                          n_true_scales=S)
    rec.put_dt("wct/R", R)
    rec.put_dt("wct/A", A)

    mesh4 = make_mesh(MeshSpec(data=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rec.put_dt("overlap", sharded_cwt_overlap_save(mesh4, xlong, sj32[:8], 0.5,
                                                       mother=mother, chunk=128))
    rec.put_dt("pencil", sharded_dft(mesh4, xsp))
    rec.put_dt("spectral", sharded_cwt_spectral(mesh4, xsp, sj32[:6], 0.5, mother=mother))
    wr, wi = sharded_cwt_spectral_planar(mesh4, xsp, sj32[:6], 0.5, mother=mother)
    rec.put_dt("spectral_planar/re", wr)
    rec.put_dt("spectral_planar/im", wi)

    cc = CACHE_CASE
    rec.put("cache/single", wct_significance(*cc["single"], device="cpu", **cc["kw"]))
    rec.put("cache/batch_mesh", wct_significance_batch(*cc["batch"], mesh=mesh, **cc["kw"]))
    rec.put("cache/batch", wct_significance_batch(*cc["batch"], device="cpu", **cc["kw"]))


def dryrun_multichip(rec: Recorder, n_devices: int) -> None:
    """The port's ``__graft_entry__.dryrun_multichip``: the sharded analysis
    step over an ``n_devices`` mesh with real data/scale/mc shardings, each
    result held on every rank against the same pipeline unsharded (the
    one-device result), rtol 2e-5 / atol 1e-6, on tiny f32 shapes."""
    import pycwt_torch as pt
    from pycwt_torch.coherence import _mc_histogram_run_pairs, _wct_core
    from pycwt_torch.config import DEFAULT, CWTConfig
    from pycwt_torch.ops.overlap import (sharded_cwt_overlap_save,
                                         sharded_wct_overlap_planar,
                                         wct_overlap_planar, cwt_overlap_save)
    from pycwt_torch.parallel import (MeshSpec, make_mesh, sharded_cwt_spectral,
                                      sharded_cwt_spectral_planar, sharded_mc_histogram,
                                      sharded_mc_histogram_pairs, sharded_power_pipeline,
                                      sharded_wct, sharded_wct_matrix, sharded_wct_pairs)
    from pycwt_torch.parallel.sharded import pad_scales
    from pycwt_torch.coherence import _mc_histogram_chunk, _wct_matrix_blocks
    from pycwt_torch.stats import PRNGKey
    from pycwt_torch.transform import build_scale_grid, cwt_batch, icwt_batch

    def check(name, sharded, ref):
        local = sharded.to_local() if hasattr(sharded, "to_local") else sharded
        np.testing.assert_allclose(
            local.detach().cpu().numpy(), np.asarray(ref), rtol=2e-5, atol=1e-6,
            err_msg=f"{name}: {n_devices}-rank result != 1-device result")

    def mine(ref, dt_out):
        """This rank's block of the global reference ``ref``."""
        coord = dt_out.device_mesh.get_coordinate()
        local = dt_out.to_local()
        sl = [slice(None)] * ref.ndim
        for i, p in enumerate(dt_out.placements):
            if p.is_shard():
                n = local.shape[p.dim]
                sl[p.dim] = slice(coord[i] * n, (coord[i] + 1) * n)
        return ref[tuple(sl)]

    scale = 2 if n_devices % 2 == 0 else 1
    mc = 2 if n_devices % 4 == 0 else 1
    data = n_devices // (scale * mc)
    mesh = make_mesh(MeshSpec(data=data, scale=scale, mc=mc))
    N0_, dt, dj = 128, 0.25, 1 / 4
    mother = pt.Morlet(6)
    grid = build_scale_grid(N0_, dt, dj=dj)
    nfft = DEFAULT.fft_length(N0_)
    sj_pad, S = pad_scales(grid.sj, scale)
    sj_pad = torch.as_tensor(sj_pad, dtype=torch.float32)
    sj_true = torch.as_tensor(grid.sj, dtype=torch.float32)
    B = 2 * data
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.standard_normal((B, N0_)), dtype=torch.float32)
    f32 = CWTConfig(dtype=torch.float32)

    outs = sharded_power_pipeline(mesh, X, sj_pad, dt, dj, mother=mother, nfft=nfft,
                                  n_true_scales=S)
    Xn = (X - X.mean(-1, keepdim=True)) / X.std(-1, correction=0, keepdim=True)
    W, _ = cwt_batch(Xn, sj_pad, dt, mother=mother, nfft=nfft, config=f32)
    p = W.abs() ** 2
    keep = (torch.arange(len(sj_pad)) < S)[:, None]
    refs = (p, p.mean(-1), icwt_batch(W * keep, sj_pad, dt, dj, mother=mother),
            (dj * dt / mother.cdelta) * (p * keep / sj_pad[:, None]).sum(-2))
    for name, o, r in zip(("power", "global_ws", "iwave", "scale_avg"), outs, refs):
        check(f"power_pipeline/{name}", o, mine(r, o))

    mc_mesh = make_mesh(MeshSpec(mc=n_devices))
    oc = mc_outsidecoi(grid.freqs, n=N0_, top=N0_ * dt / 2)
    mc_kw = dict(mother=mother, nfft=nfft, dj=dj, n=N0_, al1=0.5, al2=0.5)
    hist = sharded_mc_histogram(mc_mesh, PRNGKey(0), sj_true, oc, dt,
                                per_device_batch=1, **mc_kw)
    ref = _mc_histogram_chunk(PRNGKey(0), 0, sj_true, torch.as_tensor(oc), dt,
                              batch=n_devices, **mc_kw)
    assert int(hist.to_local().sum()) == n_devices * oc.sum()
    check("mc_histogram", hist, ref)

    slots = np.arange(n_devices) * 7919 + 13
    g1 = np.linspace(0.1, 0.7, n_devices).astype(np.float32)
    g2 = np.linspace(0.6, 0.2, n_devices).astype(np.float32)
    pk = dict(mother=mother, nfft=nfft, dj=dj, batch=2, nchunks=2, n=N0_, tau=32)
    hp = sharded_mc_histogram_pairs(mc_mesh, PRNGKey(3), sj_true, oc, slots, g1, g2, 3,
                                    dt, **pk)
    ref = _mc_histogram_run_pairs(PRNGKey(3), sj_true, torch.as_tensor(oc),
                                  torch.as_tensor(slots), torch.as_tensor(g1),
                                  torch.as_tensor(g2), 3, dt, **pk)
    check("mc_histogram_pairs", hp, mine(ref, hp))

    Y = torch.as_tensor(rng.standard_normal((B, N0_)), dtype=torch.float32)
    R, aR, _ = sharded_wct(mesh, X, Y, sj_pad, dt, dj, mother=mother, nfft=nfft,
                           n_true_scales=S)
    R_ref, aR_ref, _ = _wct_core(X, Y, sj_true, dt, mother=mother, nfft=nfft, dj=dj)
    for name, o, r in (("coherence", R, R_ref), ("phase", aR, aR_ref)):
        pad = torch.cat([r, r[:, -1:].expand(-1, len(sj_pad) - S, -1)], 1)
        m = mine(pad, o)
        S_mine = min(max(S - o.to_local().shape[1] * mesh.get_coordinate()[1], 0),
                     o.to_local().shape[1])
        check(f"wct/{name}", o.to_local()[:, :S_mine], m[:, :S_mine])

    sp_mesh = make_mesh(MeshSpec(data=n_devices))
    Nlong = n_devices * 256
    xlong = torch.as_tensor(rng.standard_normal(Nlong), dtype=torch.float32)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        Wl = sharded_cwt_overlap_save(sp_mesh, xlong, sj_true[:8], dt, mother=mother,
                                      chunk=128)
        check("overlap_save", Wl, mine(cwt_overlap_save(
            xlong, sj_true[:8], dt, mother=mother, chunk=128), Wl))
    finally:
        torch.set_default_dtype(prev)

    ylong = torch.as_tensor(rng.standard_normal(Nlong), dtype=torch.float32)
    sjc = torch.tensor([2.0, 4.0])
    Rs, As = sharded_wct_overlap_planar(sp_mesh, xlong, ylong, sjc, dt, mother=mother,
                                        dj=dj, chunk=128)
    R1, A1 = wct_overlap_planar(xlong, ylong, sjc, dt, mother=mother, dj=dj, chunk=128)
    check("wct_overlap/coherence", Rs, mine(R1, Rs))
    check("wct_overlap/phase", As, mine(A1, As))

    Nsp = max(1 << 10, n_devices * n_devices * 4)
    xsp = torch.as_tensor(rng.standard_normal(Nsp), dtype=torch.float32)
    sp_scales = sj_true[:6]
    Wsp = sharded_cwt_spectral(sp_mesh, xsp, sp_scales, dt, mother=mother)
    Wref, _ = cwt_batch(xsp[None], sp_scales, dt, mother=mother, nfft=Nsp, config=f32)
    tol = 1e-5 * float(Wref.abs().max())
    assert float((Wsp.to_local() - mine(Wref[0], Wsp)).abs().max()) < tol
    wr, wi = sharded_cwt_spectral_planar(sp_mesh, xsp, sp_scales, dt, mother=mother)
    assert float((wr.to_local() - mine(Wref[0].real, wr)).abs().max()) < tol
    assert float((wi.to_local() - mine(Wref[0].imag, wi)).abs().max()) < tol

    Xp = torch.as_tensor(rng.standard_normal((n_devices, N0_)), dtype=torch.float32)
    Yp = torch.as_tensor(rng.standard_normal((n_devices, N0_)), dtype=torch.float32)
    Rp, ap = sharded_wct_pairs(sp_mesh, Xp, Yp, sj_true, dt, dj, mother=mother, nfft=nfft)
    norm = lambda v: (v - v.mean(-1, keepdim=True)) / v.std(-1, correction=0,  # noqa: E731
                                                             keepdim=True)
    Rp_ref, ap_ref, _ = _wct_core(norm(Xp), norm(Yp), sj_true, dt, mother=mother,
                                  nfft=nfft, dj=dj)
    check("wct_pairs/coherence", Rp, mine(Rp_ref, Rp))
    check("wct_pairs/phase", ap, mine(ap_ref, ap))

    Bm = min(4, n_devices)
    mpairs = np.array([(i, (i + k) % Bm) for k in (1, 2) for i in range(Bm)], np.int64)
    while len(mpairs) % n_devices:
        mpairs = np.concatenate([mpairs, mpairs[-1:]])
    Rm, am = sharded_wct_matrix(sp_mesh, Xp[:Bm], mpairs, sj_true, dt, dj, mother=mother,
                                nfft=nfft, block=1)
    Rm_ref, am_ref = _wct_matrix_blocks(norm(Xp[:Bm]), torch.as_tensor(mpairs[:, 0]),
                                        torch.as_tensor(mpairs[:, 1]), sj_true, dt,
                                        mother=mother, nfft=nfft, dj=dj, engine=None,
                                        block=1)
    check("wct_matrix/coherence", Rm, mine(Rm_ref, Rm))
    check("wct_matrix/phase", am, mine(am_ref, am))
    rec.put("dryrun/ok", True)


# --------------------------------------------------------------------------
# The card: chip_smoke.py's phase_parallel
# --------------------------------------------------------------------------

#: phase_parallel's sizes, at the widths the JAX package's own tools use
CHIP_CWT = dict(B=8, N0=4096, dt=0.25, dj=1 / 6, J=47)      # __graft_entry__.py:18-21
CHIP_MC = dict(members=300, seed=7, pairs_batch=150)      # phase_mc_significance
CHIP_NULLS = ([0.0, 0.1, 0.2, 0.3, 0.45, 0.6, 0.75, 0.9],
              [0.05, 0.5, 0.0, 0.35, 0.2, 0.1, 0.6, 0.3])
CHIP_LONG = dict(S=64, dj=1 / 8, chunk=1 << 18, N=1 << 24, N_wct=1 << 22,
                 N_spec=1 << 22, N_spec_b=1 << 20, S_spec_b=8)
#: mesh of each surface in run A (one rank) and run B (four ranks)
CHIP_MESH_B = {"cwt": (2, 2, 1), "power_pipeline": (2, 2, 1), "wct": (2, 2, 1),
               "mc_histogram": (1, 1, 4), "mc_histogram_pairs": (1, 1, 4),
               "wct_significance_batch": (1, 1, 4), "wct_pairs": (4, 1, 1),
               "wct_matrix": (4, 1, 1), "overlap": (4, 1, 1), "wct_overlap": (4, 1, 1),
               "spectral_b": (4, 1, 1), "spectral_planar_b": (4, 1, 1)}
#: run A's surfaces beyond run B's: the full-size spectral CWT, f32 and f64
CHIP_A_ONLY = ("spectral", "spectral_f64", "spectral_planar", "spectral_planar_f64")
#: histograms and curves must agree exactly; the rest are f32 maps
CHIP_EXACT = ("mc_histogram", "mc_histogram_pairs", "wct_significance_batch")


def _stations(B=32, n0=1024):
    """tools/tpu_bench_composed.py:62-73's network: AR(1) stations with
    g ~ U(0.4, 0.8), seed 7 (as chip_smoke.py's phase_pairs)."""
    rng = np.random.default_rng(7)
    g_true = rng.uniform(0.4, 0.8, B)
    y = np.empty((B, n0))
    for b in range(B):
        e = rng.standard_normal(n0 + 256)
        for t in range(1, len(e)):
            e[t] += g_true[b] * e[t - 1]
        y[b] = e[256:]
    return y


def _chip_cases(world: int, dev: torch.device):
    """(name, call(mesh) -> {key: DTensor or tensor}, reference() -> {key:
    global tensor}, exact) of every surface, at phase_parallel's sizes."""
    import pycwt_torch as pt
    from pycwt_torch import coherence as tco
    from pycwt_torch.config import CWTConfig
    from pycwt_torch.ops import overlap as tov
    from pycwt_torch.parallel import (sharded_cwt, sharded_cwt_spectral,
                                      sharded_cwt_spectral_planar, sharded_mc_histogram,
                                      sharded_mc_histogram_pairs, sharded_power_pipeline,
                                      sharded_wct, sharded_wct_matrix, sharded_wct_pairs)
    from pycwt_torch.parallel.sharded import pad_scales
    from pycwt_torch.stats import PRNGKey, _burn_in
    from pycwt_torch.transform import build_scale_grid, cwt_batch, icwt_batch

    mother = pt.Morlet(6)
    f32 = CWTConfig(dtype=torch.float32)
    rng = np.random.default_rng(0)
    norm = lambda v: (v - v.mean(-1, keepdim=True)) / v.std(-1, correction=0,  # noqa: E731
                                                             keepdim=True)
    cases = []

    c = CHIP_CWT
    grid = build_scale_grid(c["N0"], c["dt"], dj=c["dj"], s0=2 * c["dt"], J=c["J"])
    X = torch.tensor(rng.standard_normal((c["B"], c["N0"])), dtype=torch.float32, device=dev)
    sj = torch.tensor(grid.sj, dtype=torch.float32, device=dev)
    nfft = c["N0"]

    def cwt_ref():
        W, ft = cwt_batch(X, sj, c["dt"], mother=mother, nfft=nfft, config=f32)
        return {"W": W, "ft": ft}

    cases.append(("cwt", lambda m: dict(zip(("W", "ft"), sharded_cwt(
        m, X, sj, c["dt"], mother=mother, nfft=nfft))), cwt_ref))

    def power_ref():
        W, _ = cwt_batch(norm(X), sj, c["dt"], mother=mother, nfft=nfft, config=f32)
        p = W.abs() ** 2
        return {"power": p, "gws": p.mean(-1),
                "iw": icwt_batch(W, sj, c["dt"], c["dj"], mother=mother),
                "savg": (c["dj"] * c["dt"] / mother.cdelta) * (p / sj[:, None]).sum(-2)}

    cases.append(("power_pipeline", lambda m: dict(zip(("power", "gws", "iw", "savg"),
        sharded_power_pipeline(m, X, sj, c["dt"], c["dj"], mother=mother, nfft=nfft,
                               n_true_scales=len(sj)))), power_ref))

    wgrid = build_scale_grid(4000, 1.0)                        # 133 scales, dj 1/12
    wave = np.sin(2 * np.pi * np.arange(4000) / 64.0)
    Y1 = torch.tensor(rng.standard_normal((4, 4000)) + wave, dtype=torch.float32, device=dev)
    Y2 = torch.tensor(rng.standard_normal((4, 4000)) + wave, dtype=torch.float32, device=dev)
    Y1, Y2 = norm(Y1), norm(Y2)
    wsj = torch.tensor(wgrid.sj, dtype=torch.float32, device=dev)

    def wct_call(m):
        from pycwt_torch.parallel._collectives import axis_size

        parts = axis_size(m, "scale")
        sc, S = pad_scales(wgrid.sj, parts)
        R, A, W12 = sharded_wct(m, Y1, Y2, torch.tensor(sc, dtype=torch.float32,
                                                        device=dev),
                                1.0, 1 / 12, mother=mother, nfft=4096, n_true_scales=S)
        if isinstance(W12, tuple):
            W12 = type(W12[0]).from_local(torch.complex(W12[0].to_local(), W12[1].to_local()),
                                          W12[0].device_mesh, W12[0].placements,
                                          run_check=False)
        return {"R": R, "A": A, "W12": W12}

    def wct_ref():
        R, A, W12 = tco._wct_core(Y1, Y2, wsj, 1.0, mother=mother, nfft=4096, dj=1 / 12)
        return {"R": R, "A": A,
                "W12": torch.complex(*W12) if isinstance(W12, tuple) else W12}

    cases.append(("wct", wct_call, wct_ref))

    g = np.load(os.path.join(HERE, "golden", "wct_sig_jao_jbaltic.npz"))
    mkw = dict(dt=float(g["dt"]), dj=float(g["dj"]), s0=float(g["s0"]), J=int(g["J"]))
    n, msj, oc, _, _ = tco._surrogate_grid(mkw["dt"], mkw["dj"], mkw["s0"], mkw["J"], mother)
    mnfft = 1 << (n - 1).bit_length()
    msj = torch.tensor(msj, dtype=torch.float32, device=dev)
    oc = torch.tensor(oc, device=dev)
    M = CHIP_MC["members"]
    hkw = dict(mother=mother, nfft=mnfft, dj=mkw["dj"], n=n, al1=float(g["al1"]),
               al2=float(g["al2"]))
    cases.append(("mc_histogram", lambda m: {"hist": sharded_mc_histogram(
        m, PRNGKey(CHIP_MC["seed"]), msj, oc, mkw["dt"], per_device_batch=M // world,
        **hkw)}, lambda: {"hist": tco._mc_histogram_chunk(
            PRNGKey(CHIP_MC["seed"], device=dev), 0, msj, oc, mkw["dt"], batch=M, **hkw)}))

    a1, a2 = CHIP_NULLS
    slots = np.arange(8) * 7919 + 13
    tau = _burn_in(0.9)
    tau = 1 << max(3, (tau - 1).bit_length())
    pkw = dict(mother=mother, nfft=mnfft, dj=mkw["dj"], batch=CHIP_MC["pairs_batch"],
               nchunks=2, n=n, tau=tau)
    cases.append(("mc_histogram_pairs", lambda m: {"counts": sharded_mc_histogram_pairs(
        m, PRNGKey(CHIP_MC["seed"]), msj, oc, slots, np.asarray(a1), np.asarray(a2), M,
        mkw["dt"], **pkw)}, lambda: {"counts": tco._mc_histogram_run_pairs(
            PRNGKey(CHIP_MC["seed"], device=dev), msj, oc, torch.tensor(slots, device=dev),
            torch.tensor(a1, dtype=torch.float32, device=dev),
            torch.tensor(a2, dtype=torch.float32, device=dev), M, mkw["dt"], **pkw)}))
    bkw = dict(mc_count=M, seed=CHIP_MC["seed"], cache=False, progress=False,
               alpha_quant=0, **mkw)
    cases.append(("wct_significance_batch", lambda m: {"sig": torch.as_tensor(
        tco.wct_significance_batch(a1, a2, mesh=m, **bkw))},
        lambda: {"sig": torch.as_tensor(tco.wct_significance_batch(a1, a2, device=dev,
                                                                    **bkw))}))

    y = _stations()
    sgrid = build_scale_grid(1024, 0.25)
    ssj = torch.tensor(sgrid.sj, dtype=torch.float32, device=dev)
    yt = torch.tensor(y, dtype=torch.float32, device=dev)
    all_pairs = np.array([(i, j) for i in range(32) for j in range(i + 1, 32)], np.int64)
    p16 = all_pairs[:16]
    P1 = yt[torch.as_tensor(p16[:, 0], device=dev)]
    P2 = yt[torch.as_tensor(p16[:, 1], device=dev)]

    def pairs_ref():
        R, A, _ = tco._wct_core(norm(P1), norm(P2), ssj, 0.25, mother=mother, nfft=1024,
                                dj=1 / 12)
        return {"R": R, "A": A}

    cases.append(("wct_pairs", lambda m: dict(zip(("R", "A"), sharded_wct_pairs(
        m, P1, P2, ssj, 0.25, 1 / 12, mother=mother, nfft=1024))), pairs_ref))

    def matrix_ref():
        R, A, _, _, _ = pt.wct_matrix(y, 0.25, device=dev, as_numpy=False)
        return {"R": R, "A": A}

    cases.append(("wct_matrix", lambda m: dict(zip(("R", "A"), sharded_wct_matrix(
        m, yt, all_pairs, ssj, 0.25, 1 / 12, mother=mother, nfft=1024, block=4))),
        matrix_ref))

    L = CHIP_LONG
    lsj = torch.tensor(2.0 * 2.0 ** (np.arange(L["S"]) / 8.0), dtype=torch.float32,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(L["N"], generator=gen, device=dev)
    xw1 = torch.randn(L["N_wct"], generator=gen, device=dev)
    xw2 = 0.5 * xw1 + torch.randn(L["N_wct"], generator=gen, device=dev)

    def overlap_call(m):
        prev = torch.get_default_dtype()
        torch.set_default_dtype(torch.float32)
        try:
            return {"W": tov.sharded_cwt_overlap_save(m, x, lsj, 1.0, mother=mother,
                                                      chunk=L["chunk"])}
        finally:
            torch.set_default_dtype(prev)

    cases.append(("overlap", overlap_call, lambda: {"W": tov.cwt_overlap_save(
        x, lsj, 1.0, mother=mother, chunk=L["chunk"])}))

    def wov_ref():
        R, A = tov.wct_overlap_planar(xw1, xw2, lsj, 1.0, mother=mother, dj=L["dj"],
                                      chunk=L["chunk"])
        return {"R": R, "A": A}

    cases.append(("wct_overlap", lambda m: dict(zip(("R", "A"), tov.sharded_wct_overlap_planar(
        m, xw1, xw2, lsj, 1.0, mother=mother, dj=L["dj"], chunk=L["chunk"]))), wov_ref))

    def spectral_cases(name, N, S, dtype):
        """The complex and the planar spectral CWT against the global
        transform (``cwt_batch`` in ``dtype``)."""
        xs = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(N + S),
                         device=dev).to(dtype)
        sc = lsj[:S].to(dtype)

        def ref():
            W, _ = cwt_batch(xs[None], sc, 1.0, mother=mother, nfft=N,
                             config=CWTConfig(dtype=dtype))
            return {"W": W[0]}

        def ref_planes():
            W = ref()["W"]
            return {"re": W.real, "im": W.imag}

        cases.append((name, lambda m: {"W": sharded_cwt_spectral(m, xs, sc, 1.0,
                                                                 mother=mother)}, ref))
        cases.append((name.replace("spectral", "spectral_planar"), lambda m: dict(zip(
            ("re", "im"), sharded_cwt_spectral_planar(m, xs, sc, 1.0, mother=mother))),
            ref_planes))

    spectral_cases("spectral", L["N_spec"], L["S"], torch.float32)
    spectral_cases("spectral_f64", L["N_spec"], L["S"], torch.float64)
    spectral_cases("spectral_b", L["N_spec_b"], L["S_spec_b"], torch.float32)
    if world > 1:
        cases = [cs for cs in cases if cs[0] not in CHIP_A_ONLY]
    return cases


#: run A's bound on a surface against the unsharded port, relative to
#: max|ref|, where the two are different algorithms or blockings: the
#: spectral CWT against the global transform (K1+K2's `high` tier in f32,
#: chip_smoke.py's TIER_BOUND; tests/test_dist_fft.py:90's 1e-10 in f64) and
#: wct_matrix's blocks of 4 against its own blocking (K1+K2's `highest`).
#: Every other surface runs the same kernels on the same shapes as its
#: unsharded counterpart and must equal it bit for bit.
CHIP_A_BOUND = {"spectral": 2e-4, "spectral_f64": 1e-10, "spectral_b": 2e-4,
                "spectral_planar": 2e-4, "spectral_planar_f64": 1e-10,
                "spectral_planar_b": 2e-4, "wct_matrix": 1e-5}


def _block_of(saved: np.ndarray, dt_out):
    """(this rank's local block, the matching slice of run A's ``saved``
    global result), clipped to ``saved``'s extent (padded scale rows)."""
    local = dt_out.to_local() if hasattr(dt_out, "to_local") else dt_out
    sl = [slice(None)] * local.ndim
    if hasattr(dt_out, "placements"):
        coord = dt_out.device_mesh.get_coordinate()
        for i, p in enumerate(dt_out.placements):
            if p.is_shard():
                n = local.shape[p.dim]
                lo = coord[i] * n
                hi = min(lo + n, saved.shape[p.dim])
                sl[p.dim] = slice(lo, hi)
    ref = np.asarray(saved[tuple(sl)])
    return local[tuple(slice(0, k) for k in ref.shape)], ref


def _err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |got − ref|, and its worst ratio to 1e-6·max|ref| + 2e-5·|ref|
    (__graft_entry__.py:90-95's rtol / atol, the atol scaled by max|ref|)."""
    diff = (got - ref).abs().to(torch.float64).nan_to_num()
    mag = ref.abs().to(torch.float64).nan_to_num()
    peak = float(mag.max()) if mag.numel() else 0.0
    return dict(max_abs=float(diff.max()), max_rel_to_peak=float(diff.max()) / max(peak, 1e-300),
                ratio=float((diff / (1e-6 * peak + 2e-5 * mag + 1e-300)).max()))


def chip_job(rank: int, world: int, backend: str, out_dir: str, device="cuda") -> dict:
    """One rank of chip_smoke.py's phase_parallel: run A (world 1, NCCL) holds
    every surface against the unsharded port on the card and saves its
    results under ``out_dir``; run B (world 4, gloo on the card) holds each
    rank's block against its slice of run A's.  Returns the report that the
    rank also writes to ``out_dir``."""
    import json
    import time

    import torch.distributed as dist

    from pycwt_torch.ops import fused_cwt as fc
    from pycwt_torch.parallel import MeshSpec, make_mesh

    run = "A" if world == 1 else "B"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    init_rank(rank, world, "file://" + os.path.join(out_dir, f"rendezvous-{run}"), device,
              backend)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device(device)
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe)                       # the group's backend moves a card tensor
    report = dict(rank=rank, world=world, backend=backend, imports_clean=imports_clean(),
                  all_reduce_probe=float(probe), init_s=time.perf_counter() - t0,
                  surfaces={})

    def events_ms(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    warnings.simplefilter("ignore")       # the overlap grids' near-Nyquist caveat
    for name, call, ref_fn in _chip_cases(world, dev):
        mesh = make_mesh(MeshSpec(*(CHIP_MESH_B[name] if run == "B" else (1, 1, 1))))
        for k in fc.KERNEL_LAUNCHES:
            fc.KERNEL_LAUNCHES[k] = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms0, outs = events_ms(lambda: call(mesh))
        launches = dict(fc.KERNEL_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - base
        times = []
        for _ in range(3):
            ms, res = events_ms(lambda: call(mesh))
            times.append(ms)
            del res
        errs = {}
        refs = ref_fn() if run == "A" else None
        for key, o in outs.items():
            path = os.path.join(out_dir, f"A-{name}-{key}.npy")
            local = o.to_local() if hasattr(o, "to_local") else o
            if run == "A":
                got, want = local, refs[key]
                e = _err(got, want)
                if name in CHIP_A_BOUND:
                    e["ok"] = e["max_rel_to_peak"] <= CHIP_A_BOUND[name]
                if name not in CHIP_A_ONLY:
                    np.save(path, local.cpu().numpy())
            else:
                got, want = _block_of(np.load(path, mmap_mode="r"), o)
                want = torch.as_tensor(want).to(got.device)
                e = _err(got, want)
                if name not in CHIP_EXACT:
                    e["ok"] = e["ratio"] <= 1.0
            e["exact"] = bool(torch.equal(got, want.to(got.dtype)))
            if got.is_floating_point():           # the curves' NaN rows
                e["exact"] = bool(torch.equal(got.isnan(), want.isnan())) and bool(
                    torch.equal(got.nan_to_num(), want.to(got.dtype).nan_to_num()))
            e.setdefault("ok", e["exact"])
            if key == "A":
                # The phase of the unsmoothed cross spectrum is noise where
                # it is near zero, in any formulation: it is held where it
                # must be bit for bit, elsewhere its wrapped difference is
                # reported (run B holds the cross spectrum W12 instead).
                d = torch.remainder(got - want + math.pi, 2 * math.pi) - math.pi
                e["wrapped_max_abs"] = float(d.abs().max())
                e["ok"] = e["exact"] or run == "B" or name in CHIP_A_BOUND
            errs[key] = e
        del outs, refs
        torch.cuda.empty_cache()
        report["surfaces"][name] = dict(
            mesh=CHIP_MESH_B[name] if run == "B" else (1, 1, 1), first_ms=ms0,
            ms=float(np.median(times)), ms_runs=times, launches=launches,
            peak_bytes=peak, max_memory_allocated=torch.cuda.max_memory_allocated(),
            errs=errs)
    report["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"{run}-rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return report


JOBS = {"sharding": job_sharding, "dist_fft": job_dist_fft, "multihost": job_multihost}


def init_rank(rank: int, world: int, init: str, device: str, backend: str) -> None:
    """Start this rank's process group; the port must not have imported JAX."""
    from pycwt_torch.parallel.distributed import initialize

    initialize(init, world, rank, device=device, backend=backend)


def imports_clean() -> bool:
    """True when importing the whole port left JAX and ``pycwt_tpu`` out."""
    import pycwt_torch  # noqa: F401
    import pycwt_torch.analysis  # noqa: F401
    import pycwt_torch.examples.sample_cwt  # noqa: F401
    import pycwt_torch.examples.sample_network  # noqa: F401
    import pycwt_torch.examples.sample_xwt  # noqa: F401
    import pycwt_torch.ops.overlap  # noqa: F401
    import pycwt_torch.ops.twofloat  # noqa: F401
    import pycwt_torch.parallel  # noqa: F401
    import pycwt_torch.parallel.distributed  # noqa: F401
    import pycwt_torch.utils.profiling  # noqa: F401
    return "jax" not in sys.modules and "pycwt_tpu" not in sys.modules


def rank_main(argv: list[str]) -> None:
    job, rank, world, init, out, device, backend = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    rec = Recorder()
    rec.put("imports_clean", imports_clean())
    if job in ("sharding", "dist_fft"):
        torch.set_default_dtype(torch.float64)
    init_rank(rank, world, init, device, backend)
    import torch.distributed as dist

    try:
        JOBS[job](rec, world)
        rec.save(os.path.join(out, f"rank{rank}.npz"))
    finally:
        dist.destroy_process_group()


def test_init_method():
    from pycwt_torch.parallel.distributed import _init_method

    assert _init_method(None) == "env://"
    assert _init_method("10.0.0.2:29500") == "tcp://10.0.0.2:29500"
    assert _init_method("file:///tmp/rdv") == "file:///tmp/rdv"


def test_world_of_one_without_a_group():
    """No process group: one process, the coordinator, whose broadcast is
    the identity; a mesh of more than one rank names initialize."""
    import torch.distributed as dist

    from pycwt_torch.parallel import MeshSpec, make_mesh
    from pycwt_torch.parallel.distributed import (host_broadcast_array, is_coordinator,
                                                  process_count)

    assert not dist.is_initialized()
    assert process_count() == 1 and is_coordinator()
    x = np.arange(3.0)
    assert host_broadcast_array(x) is x
    with pytest.raises(RuntimeError, match="parallel.distributed.initialize"):
        make_mesh(MeshSpec(data=2, mc=2))
    assert MeshSpec(data=2, scale=3, mc=4).ndevices == 24


def test_pad_scales():
    from pycwt_torch.parallel.sharded import pad_scales

    sj = np.arange(1.0, 8.0)
    padded, S = pad_scales(sj, 4)
    assert S == 7 and padded.tolist() == [1, 2, 3, 4, 5, 6, 7, 7]
    same, S = pad_scales(sj[:4], 2)
    assert S == 4 and same.tolist() == [1, 2, 3, 4]


@pytest.mark.parametrize("n, up, down", [(1, 2, 3), (2, 1, 2), (4, 3, 2), (8, 5, 0)])
def test_shift_split_table(n, up, down):
    """Each rank sends its first ``up`` rows back and last ``down`` rows on;
    what one rank sends a peer, the peer expects from it."""
    from pycwt_torch.parallel._collectives import _shift_splits

    table = [_shift_splits(r, n, up, down) for r in range(n)]
    for r, (send, recv) in enumerate(table):
        assert sum(send) == (up if r > 0 else 0) + (down if r < n - 1 else 0)
        assert sum(recv) == (down if r > 0 else 0) + (up if r < n - 1 else 0)
        for peer in range(n):
            assert send[peer] == table[peer][1][r]
            assert (send[peer] > 0) <= (abs(peer - r) == 1)


@pytest.mark.parametrize("N, D, match", [(1000, 8, "pow-2"), (32, 8, "pencil"),
                                         (1024, 6, "mesh axis size must be pow-2")])
def test_split_for_rejects(N, D, match):
    from pycwt_torch.parallel.dist_fft import _split_for

    with pytest.raises(ValueError, match=match):
        _split_for(N, D)


def test_split_for_balanced():
    from pycwt_torch.parallel.dist_fft import _split_for

    assert _split_for(1 << 8, 8) == (16, 16)
    assert _split_for(1 << 13, 8) == (64, 128)
    assert _split_for(1 << 22, 4) == (2048, 2048)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    rank_main(sys.argv[1:])
