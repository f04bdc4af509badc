"""The port's f32 matrix products run in full f32 whatever the process sets
(``pycwt_torch/ops/_precision.full_f32_matmul``), as ``pycwt_tpu`` pins
``jax.lax.Precision.HIGHEST``: under ``torch.set_float32_matmul_precision``
"high" or "medium" (bf16 through oneDNN on the CPU), ``allow_tf32`` or the
newer ``fp32_precision`` settings, every surface that reaches one gives the
bits it gives under "highest", within its bound of pycwt_tpu, and the
caller's setting reads back unchanged, also when the call raises.  A
fixture puts the process setting back after every case: the test files
share their worker process."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
import pycwt_torch as pt
from pycwt_tpu import coherence as jco
from pycwt_tpu.analysis import global_spectrum as jglobal_spectrum
from pycwt_tpu.config import CWTConfig as JConfig
from pycwt_tpu.ops import smoothing as jsm
from pycwt_torch import coherence as tco
from pycwt_torch.analysis import global_spectrum
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import smoothing as tsm
from pycwt_torch.ops._precision import full_f32_matmul
from test_torch_matmul_pin_support import CALLERS, restore, state

torch.set_num_threads(2)

PLANAR = CWTConfig(engine="planar")
M6 = pt.Morlet(6)


@pytest.fixture(autouse=True)
def process_setting():
    """Put the process's precision settings back after every case."""
    saved = state()
    yield
    restore(saved)
    assert state() == saved


def _ar1(rng, n, g):
    e = rng.standard_normal(n + 100)
    for i in range(1, len(e)):
        e[i] += g * e[i - 1]
    return e[100:]


def _inputs():
    rng = np.random.default_rng(0)
    y1 = _ar1(rng, 885, 0.7)
    return dict(
        y1=y1, y2=0.5 * y1 + _ar1(rng, 885, 0.5),
        Y=np.stack([_ar1(rng, 512, 0.6) for _ in range(4)]),
        Ta=rng.standard_normal((3, 40, 300)).astype(np.float32),
        Tb=rng.standard_normal((3, 40, 300)).astype(np.float32),
        sj=(2.0 * 2 ** (np.arange(40) / 8)).astype(np.float32),
        g1=rng.standard_normal(512).astype(np.float32),
        g2=rng.standard_normal(512).astype(np.float32))


def _gradient(inp, engine):
    """d mean(WCT) / d y1 through ``_wct_core`` on ``engine``, f32."""
    a = torch.tensor(inp["g1"], requires_grad=True)
    R, _, _ = tco._wct_core(a[None], torch.tensor(inp["g2"])[None],
                            torch.tensor([4.0, 8.0, 16.0, 32.0]), 1.0, mother=M6,
                            nfft=512, dj=0.5, engine=engine)
    (g,) = torch.autograd.grad(R.mean(), a)
    return g.numpy()


def _surfaces(inp):
    """name -> result of every port surface that runs an f32 product."""
    Ta, Tb, sj = (torch.tensor(inp[k]) for k in ("Ta", "Tb", "sj"))
    out = {}
    out["smooth"] = tsm.smooth(Ta, 1.0, 1 / 8, sj, M6).numpy()
    out["smooth_planar_real"] = tsm.smooth_planar_real(Ta, 1.0, 1 / 8, sj, M6).numpy()
    out["smooth_planar_pair"] = np.stack(
        [p.numpy() for p in tsm.smooth_planar_pair(Ta, Tb, 1.0, 1 / 8, sj, M6)])
    for route, cfg in (("default", CWTConfig()), ("planar", PLANAR)):
        out[f"wct_{route}"] = pt.wct(inp["y1"], inp["y2"], 0.25, sig=False,
                                     config=cfg, device="cpu")[0]
    out["wct_matrix"] = pt.wct_matrix(inp["Y"], 1.0, config=PLANAR, device="cpu")[0]
    out["global_spectrum"] = global_spectrum(inp["y1"], 0.25, device="cpu")[0]
    for engine in ("xla", "planar"):
        out[f"gradient_{engine}"] = _gradient(inp, engine)
    # K3's plain versions: a complex product with the DFT matrix, and the
    # Stockham mirror's R-point DFTs
    spec = torch.fft.fft(torch.tensor(inp["Y"], dtype=torch.float32), n=512)
    kw = dict(mother=M6, nfft=512, dt=1.0)
    out["direct_reference"] = np.stack([p.numpy() for p in fc.fused_cwt_planar(
        spec.real, spec.imag, sj[:8], small_kernel=True, **kw)])
    out["direct_stockham"] = np.stack([p.numpy() for p in fc._direct_stockham_reference(
        spec.real, spec.imag, sj[:8], **kw)])
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def highest(inputs):
    """Every surface under "highest"."""
    saved = state()
    torch.set_float32_matmul_precision("highest")
    try:
        return _surfaces(inputs)
    finally:
        restore(saved)


@pytest.fixture(scope="module")
def jax_results(inputs):
    """pycwt_tpu on the same numpy inputs (f32, HIGHEST in its smoothing)."""
    inp = inputs
    Ta, Tb, sj = (jnp.asarray(inp[k]) for k in ("Ta", "Tb", "sj"))
    out = {"smooth": jsm.smooth(Ta, 1.0, 1 / 8, sj, wt.Morlet(6)),
           "smooth_planar_real": jsm.smooth_planar_real(Ta, 1.0, 1 / 8, sj, wt.Morlet(6)),
           "smooth_planar_pair": jnp.stack(
               jsm.smooth_planar_pair(Ta, Tb, 1.0, 1 / 8, sj, wt.Morlet(6)))}
    for route, cfg in (("default", JConfig()), ("planar", JConfig(engine="planar"))):
        out[f"wct_{route}"] = wt.wct(inp["y1"], inp["y2"], 0.25, sig=False,
                                     config=cfg)[0]
    out["wct_matrix"] = jco.wct_matrix(inp["Y"], 1.0, config=JConfig(engine="planar"))[0]
    out["global_spectrum"] = jglobal_spectrum(inp["y1"], 0.25)[0]

    def jloss(v):
        R, _, _ = jco._wct_core(v[None], jnp.asarray(inp["g2"])[None],
                                jnp.asarray([4.0, 8.0, 16.0, 32.0]), 1.0,
                                mother=wt.Morlet(6), nfft=512, dj=0.5, engine="xla")
        return R.mean()

    out["gradient"] = jax.grad(jloss)(jnp.asarray(inp["g1"]))
    return {k: np.asarray(v) for k, v in out.items()}


#: surface -> (pycwt_tpu's result, bound on max|Δ| / max|pycwt_tpu|).  The
#: default-route WCT is the figure bf16 moved by 5.5e-3; the planar route's
#: maps and gradient differ from pycwt_tpu's by its f32 forward spectrum as
#: well (the port takes it in f64), up to 1.5e-6 here.
AGAINST_JAX = {"smooth": ("smooth", 1e-6),
               "smooth_planar_real": ("smooth_planar_real", 1e-6),
               "smooth_planar_pair": ("smooth_planar_pair", 1e-6),
               "wct_default": ("wct_default", 1e-6),
               "wct_planar": ("wct_planar", 2e-6),
               "wct_matrix": ("wct_matrix", 2e-6),
               "global_spectrum": ("global_spectrum", 1e-6),
               "gradient_xla": ("gradient", 1e-6),
               "gradient_planar": ("gradient", 2e-6)}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_f32_products_ignore_the_process_setting(inputs, highest, jax_results, caller):
    """Under each caller setting every surface gives its "highest" bits,
    within its bound of pycwt_tpu, and the setting reads back unchanged."""
    CALLERS[caller]()
    before = state()
    got = _surfaces(inputs)
    assert state() == before
    for name, ref in highest.items():
        assert np.array_equal(got[name], ref, equal_nan=True), name
    for name, (jname, bound) in AGAINST_JAX.items():
        want = jax_results[jname]
        err = np.nanmax(np.abs(got[name] - want)) / np.nanmax(np.abs(want))
        assert err < bound, (name, err)


@pytest.mark.parametrize("caller", list(CALLERS))
def test_the_setting_reads_back_after_a_call_that_raises(caller):
    """A product that raises inside the pin, forward or in the scope
    itself, leaves the caller's setting as it was."""
    CALLERS[caller]()
    before = state()
    with pytest.raises(RuntimeError):
        tsm._band_product(torch.ones(3, 3), torch.ones(2, 4, 5))
    assert state() == before
    with pytest.raises(ZeroDivisionError):
        with full_f32_matmul():
            assert torch.backends.cuda.matmul.fp32_precision == "ieee"
            assert torch.backends.mkldnn.matmul.fp32_precision == "ieee"
            1 / 0
    assert state() == before


def test_band_product_backward_is_pinned(monkeypatch):
    """An autograd backward runs after the forward's scope has closed: the
    band product's Function takes the pin again for Mᵀ·grad."""
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append((torch.backends.cuda.matmul.fp32_precision,
                     torch.backends.mkldnn.matmul.fp32_precision))
        return real(a, b)

    torch.set_float32_matmul_precision("medium")
    M = torch.rand(5, 5)
    T = torch.rand(2, 5, 7, requires_grad=True)
    out = tsm._band_product(M, T)
    monkeypatch.setattr(torch, "matmul", spy)
    (g,) = torch.autograd.grad(out.sum(), T)
    assert seen == [("ieee", "ieee")]
    monkeypatch.undo()
    with full_f32_matmul():
        assert torch.equal(g, torch.matmul(M.mT, torch.ones(2, 5, 7)))


@pytest.mark.parametrize("fn", ["smooth_planar_real", "smooth_planar_pair"])
def test_planar_smoothing_takes_pycwt_tpus_precision(inputs, fn):
    """``precision=`` as pycwt_tpu's: None means "highest", each tier runs
    the same full-f32 product, any other value raises."""
    Ta, Tb, sj = (torch.tensor(inputs[k]) for k in ("Ta", "Tb", "sj"))
    args = (Ta,) if fn == "smooth_planar_real" else (Ta, Tb)
    call = getattr(tsm, fn)
    ref = call(*args, 1.0, 1 / 8, sj, M6)
    for tier in (None, "highest", "high", "fast"):
        got = call(*args, 1.0, 1 / 8, sj, M6, precision=tier)
        assert all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            ref if isinstance(ref, tuple) else (ref,)))
    with pytest.raises(ValueError, match="precision"):
        call(*args, 1.0, 1 / 8, sj, M6, precision="bf16")
