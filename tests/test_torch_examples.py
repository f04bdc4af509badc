"""The port's example workflows (pycwt_torch/examples/) on the CPU.

Each script runs as a child process with ``--device cpu`` and
``PYCWT_TPU_MC_COUNT=10``, as tests/test_analysis.py:50-65 runs the JAX
ones, and prints the numbers the JAX script prints when run the same way
(``PYCWT_TPU_PLATFORM=cpu``), to one unit of the last printed digit.  Each
``run(...)`` in float64 equals the ``pycwt_tpu.analysis`` call on the same
inputs (1e-10; the Monte-Carlo curves 1e-9 on the same threefry members).
Without a card the default ``--device cuda`` stops and names
``--device cpu``."""
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pycwt_tpu as wt
from pycwt_tpu import analysis as jan
from pycwt_tpu.sample import load as jload
from pycwt_torch.examples import sample_cwt, sample_network, sample_xwt
from tests.conftest import rel_err

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("sample_cwt", "sample_xwt", "sample_network")
#: the lines of each script's own summary (the progress lines of the
#: Monte-Carlo run differ between the packages and are left out)
SUMMARY = {"sample_cwt": (" scales, alpha=", "reconstruction rms err"),
           "sample_xwt": ("XWT:", "WCT:"),
           "sample_network": ("network:", "significant fraction", "OK")}
CHILD_TIMEOUT = 240
NUMBER = re.compile(r"-?\d+(?:\.(\d+))?")


def _args(name, outdir):
    if name == "sample_cwt":
        return ["--all", "--outdir", outdir]
    return ["--outdir", outdir] if name == "sample_xwt" else []


def _start(cmd, env, cwd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=cwd)


def _finish(proc):
    """(return code, stdout, stderr), the child killed after CHILD_TIMEOUT."""
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return None, out, err
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of this file, started together: each port script with
    ``--device cpu``, each JAX script on the CPU, and each port script with
    no ``--device`` (the card by default)."""
    tmp = tmp_path_factory.mktemp("examples")
    env = {**os.environ, "PYCWT_TPU_MC_COUNT": "10",
           "PYCWT_TPU_CACHE_DIR": str(tmp / "cache"), "OMP_NUM_THREADS": "2",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("PYCWT_TPU_PLATFORM", None)
    procs = {}
    for name in EXAMPLES:
        outdir = tmp / name
        outdir.mkdir()
        module = ["-m", f"pycwt_torch.examples.{name}"]
        procs["torch", name] = _start(
            [sys.executable, *module, "--device", "cpu", *_args(name, str(outdir))],
            env, REPO)
        procs["jax", name] = _start(
            [sys.executable, os.path.join(REPO, "examples", f"{name}.py"),
             *_args(name, str(outdir))], {**env, "PYCWT_TPU_PLATFORM": "cpu"}, REPO)
        procs["default", name] = _start([sys.executable, *module], env, REPO)
    return {key: _finish(proc) for key, proc in procs.items()}


def _summary(name, stdout):
    return [ln for ln in stdout.splitlines()
            if any(key in ln for key in SUMMARY[name])]


def _numbers(line):
    """Each number of ``line`` with one unit of its last printed digit."""
    return [(float(m.group(0)), 10.0 ** -len(m.group(1) or ""))
            for m in NUMBER.finditer(line)]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_cpu_and_prints_the_jax_numbers(children, name):
    rc, out, err = children["torch", name]
    assert rc == 0, err[-2000:]
    jrc, jout, jerr = children["jax", name]
    assert jrc == 0, jerr[-2000:]
    got, ref = _summary(name, out), _summary(name, jout)
    assert len(got) == len(ref) > 0, (out, jout)
    for line, jline in zip(got, ref):
        nums, jnums = _numbers(line), _numbers(jline)
        assert len(nums) == len(jnums), (line, jline)
        for (a, unit), (b, _) in zip(nums, jnums):
            assert abs(a - b) <= unit * (1 + 1e-9), (line, jline)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_a_card_names_device_cpu(children, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    rc, out, err = children["default", name]
    assert rc not in (0, None), out
    assert "--device cpu" in err, err[-2000:]
    assert "reconstruction" not in out and "XWT" not in out and "network" not in out


@pytest.fixture
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


@pytest.mark.parametrize("name", sample_cwt.DATASETS)
def test_sample_cwt_run_matches_jax(f64, name):
    out = sample_cwt.run(name, device="cpu")
    res = out["res"]
    ds = jload(name)
    ref = jan.cwt_analysis(ds.values, ds.dt, t0=ds.t0, mother=wt.Morlet(6),
                           avg_band=(2, 8))
    for field in ("W", "power", "sig95", "global_power", "global_signif",
                  "scale_avg", "iwave", "scales", "coi", "t"):
        assert rel_err(getattr(res, field), getattr(ref, field)) < 1e-10, field
    for field in ("alpha", "scale_avg_signif", "std"):
        np.testing.assert_allclose(getattr(res, field), getattr(ref, field), rtol=1e-10)
    _, fft_theor = wt.significance(1.0, ds.dt, ref.scales, 0, alpha=ref.alpha,
                                   wavelet=wt.Morlet(6))
    assert rel_err(out["fft_theor"], fft_theor) < 1e-10
    assert np.isclose(out["rms_err"],
                      np.sqrt(np.mean((ref.iwave / ref.std - ref.signal) ** 2)), rtol=1e-10)


def test_sample_xwt_run_matches_jax(f64):
    out = sample_xwt.run(mc_count=10, device="cpu")
    jao, jba = jload("jao"), jload("jbaltic")
    n = min(jao.values.size, jba.values.size)
    y1, y2 = jao.values[:n], jba.values[:n]
    x = jan.xwt_analysis(y1, y2, jao.dt, boxpdf_transform=True)
    w = jan.wct_analysis(y1, y2, jao.dt, sig=True, mc_count=10, progress=False,
                         cache=False)
    for field in ("cross_power", "cross_sig", "coi", "period", "signif"):
        assert rel_err(out["xwt"][field], x[field]) < 1e-10, field
    for field in ("WCT", "coi", "period"):
        assert rel_err(out["wct"][field], w[field]) < 1e-10, field
    m = np.abs(x["W12"]) > 1e-3 * np.abs(x["W12"]).max()
    dphi = np.angle(np.exp(1j * (out["xwt"]["phase"] - x["phase"])))[m]
    assert np.abs(dphi).max() < 1e-10
    np.testing.assert_allclose(out["wct"]["sig95"], w["sig95"], atol=1e-9)
    np.testing.assert_allclose(out["u"], np.sin(out["wct"]["phase"]))
    assert out["t"].shape == (n,)


def _jax_example_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sample_network_run_matches_jax(f64):
    out = sample_network.run(B=4, mc_count=10, device="cpu")
    y = _jax_example_module("sample_network").make_network(B=4)
    np.testing.assert_array_equal(out["y"], y)
    ref = jan.wct_matrix_analysis(y, dt=1.0, mc_count=10, cache=False)
    np.testing.assert_array_equal(out["res"]["pairs"], ref["pairs"])
    for field in ("WCT", "alpha", "coi", "period"):
        assert rel_err(out["res"][field], ref[field]) < 1e-10, field
    np.testing.assert_allclose(out["res"]["sig95"], ref["sig95"], atol=1e-9)
    coupled, background = sample_network.band_fractions(ref, 4)
    assert out["coupled"] == coupled and out["background"] == background
