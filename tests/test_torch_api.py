"""The port's public surface against pycwt_tpu's: every public function both
packages define has the same parameters (names, kinds, defaults) but for an
explicit allow-list; the engine default by device and dtype; the ops
keywords the port accepts for calls written against pycwt_tpu."""
import importlib
import inspect
import pkgutil
import warnings

import numpy as np
import pytest
import torch

import pycwt_torch
import pycwt_torch as pt
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import fft as tfft
from pycwt_torch.ops import fused_cwt as fc
from pycwt_torch.ops import mxu_dft

torch.set_num_threads(2)

#: port module -> pycwt_tpu module (the rest map by package name)
MODULE_OF = {"pycwt_torch.ops.fused_cwt": "pycwt_tpu.ops.pallas_fft",
             **{f"pycwt_torch.parallel.{m}": f"pycwt_tpu.parallel.{m}"
                for m in ("mesh", "distributed", "sharded", "dist_fft")}}
#: (module, function) -> parameters only the port has (besides ``device``):
#: the process group's device and backend, and the mesh that the JAX
#: package's sharded smoothing finds in its enclosing shard_map
PORT_ONLY = {("pycwt_torch.ops.fft", "resolve_engine"): {"dtype"},
             ("pycwt_torch.parallel.distributed", "initialize"): {"device", "backend"},
             ("pycwt_torch.ops.smoothing", "scale_boxcar_same_sharded"): {"mesh"},
             ("pycwt_torch.ops.smoothing", "smooth_scale_sharded"): {"mesh"}}
#: (module, function) -> pycwt_tpu parameters the port dropped (none now:
#: the planar smoothings take the precision, each tier in full f32)
JAX_ONLY = {}
#: (module, function) -> {port name: pycwt_tpu name}: rednoise_batch draws
#: from a torch.Generator where pycwt_tpu takes a jax.random key
RENAMED = {("pycwt_torch.stats", "rednoise_batch"): {"generator": "key"}}


def _default(value):
    """A default in comparable form: dtypes by name (torch.float32 and
    jnp.float32 are both "float32"), jax.lax.Precision by its lower-case
    name (the port takes the tier as a string)."""
    if isinstance(value, torch.dtype):
        return str(value).rsplit(".", 1)[-1]
    if isinstance(value, type) and value.__module__.startswith("jax"):
        return value.__name__
    if type(value).__name__ == "Precision":
        return repr(value.name.lower())
    return repr(value)


def _params(fn, drop=(), rename=None):
    rename = rename or {}
    return [(rename.get(p.name, p.name), p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values() if p.name not in drop]


def _shared_functions():
    """(port module, name, port function, pycwt_tpu function) of every
    public function a port module defines that its pycwt_tpu module has."""
    out = []
    for info in pkgutil.walk_packages(pycwt_torch.__path__, "pycwt_torch."):
        tname = info.name
        jname = MODULE_OF.get(tname, tname.replace("pycwt_torch", "pycwt_tpu", 1))
        try:
            jmod = importlib.import_module(jname)
        except ImportError:
            continue                       # a port-only module (ops._build)
        tmod = importlib.import_module(tname)
        for name, fn in vars(tmod).items():
            if (name.startswith("_") or not inspect.isfunction(fn)
                    or fn.__module__ != tname or not hasattr(jmod, name)):
                continue
            out.append((tname, name, fn, getattr(jmod, name)))
    return out


def test_public_signatures_match_pycwt_tpu():
    shared = _shared_functions()
    names = {(m, n) for m, n, _, _ in shared}
    # the surface this slice ported is among them
    for fn in ("wct_significance", "wct_significance_batch", "wct",
               "mc_significance_from_histogram", "xwt_pairs", "xwt_pairs_planar",
               "wct_pairs", "wct_matrix"):
        assert ("pycwt_torch.coherence", fn) in names
    for fn in ("rednoise_members", "rednoise_members_pairs"):
        assert ("pycwt_torch.stats", fn) in names
    assert ("pycwt_torch.analysis", "wct_matrix_analysis") in names
    for fn in ("halo_samples", "cwt_overlap_save", "cwt_overlap_save_planar",
               "streamed_global_power", "streamed_global_power_planar",
               "wct_overlap_planar", "xwt_overlap_planar"):
        assert ("pycwt_torch.ops.overlap", fn) in names
    for fn in ("df_from_f64", "df_to_f64", "df_add", "df_sub", "df_mul", "fft_df",
               "cwt_twofloat", "smooth_twofloat", "xwt_twofloat", "wct_twofloat"):
        assert ("pycwt_torch.ops.twofloat", fn) in names
    for fn in ("trace", "log_sharding"):
        assert ("pycwt_torch.utils.profiling", fn) in names
    assert ("pycwt_torch.utils.helpers", "enable_compilation_cache") in names
    for fn in ("sharded_cwt_overlap_save", "sharded_wct_overlap_planar"):
        assert ("pycwt_torch.ops.overlap", fn) in names
    for fn in ("scale_boxcar_same_sharded", "smooth_scale_sharded"):
        assert ("pycwt_torch.ops.smoothing", fn) in names
    assert {"make_mesh", "initialize", "is_coordinator", "host_broadcast_array",
            "pad_scales", "sharded_cwt", "sharded_power_pipeline", "sharded_wct",
            "sharded_wct_pairs", "sharded_wct_matrix", "sharded_mc_histogram",
            "sharded_mc_histogram_pairs", "sharded_dft", "sharded_idft",
            "sharded_dft_planar", "sharded_cwt_spectral",
            "sharded_cwt_spectral_planar"} <= {n for m, n in names
                                               if m.startswith("pycwt_torch.parallel.")}
    used = set()
    mismatches = []
    for mod, name, tfn, jfn in shared:
        key = (mod, name)
        drop = {"device"} | PORT_ONLY.get(key, set())
        got = _params(tfn, drop=drop, rename=RENAMED.get(key))
        want = _params(jfn, drop=JAX_ONLY.get(key, set()))
        if got != want:
            mismatches.append(f"{mod}.{name}: {got} != {want}")
        for table in (PORT_ONLY, JAX_ONLY, RENAMED):
            if key in table:
                used.add(key)
    assert not mismatches, "\n".join(mismatches)
    # every allow-list entry still names a real difference
    assert used == set(PORT_ONLY) | set(JAX_ONLY) | set(RENAMED)


@pytest.mark.parametrize("device, dtype, engine", [
    ("cuda", torch.float32, "planar"),
    (torch.device("cuda", 0), torch.float32, "planar"),
    ("cuda", torch.float64, "xla"),
    ("cpu", torch.float32, "xla"),
    ("cpu", torch.float64, "xla"),
    (None, torch.float32, "xla"),
])
def test_resolve_engine_by_device_and_dtype(monkeypatch, device, dtype, engine):
    """engine=None: planar only for f32 on CUDA; f64 on the card is cuFFT."""
    monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    assert tfft.resolve_engine(None, device, dtype) == engine
    assert tfft.resolve_engine("mxu", device, dtype) == "mxu"


def test_resolve_engine_dtype_none_follows_default_dtype(monkeypatch):
    monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    prev = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float64)
        assert tfft.resolve_engine(None, "cuda") == "xla"
        torch.set_default_dtype(torch.float32)
        assert tfft.resolve_engine(None, "cuda") == "planar"
    finally:
        torch.set_default_dtype(prev)


#: nfft -> the record length that pads to it (100 itself unpadded)
ROUTE_N0 = {100: 100, 128: 100, 256: 200, 1 << 12: 3000}


@pytest.mark.parametrize("nfft", sorted(ROUTE_N0))
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("engine", [None, "xla", "mxu", "pallas", "planar"])
def test_f64_policy_names_the_cache_as_xla_on_the_card(monkeypatch, engine, dtype,
                                                        device, nfft):
    """The one route decision, ``ops/fft._planar_route``: the planar route is
    engine "planar" (the default only for f32 on the card) at a pow-2 nfft,
    and an f64 computation sent there warns.  The MC cache policy resolves
    with the dtype too (an f64 config on the card is the reference's xla-f64
    regime) and names the planar engine wherever the route is planar; on the
    CPU cwt_power, the WCT core and wct_matrix's core take the planar entry
    (``_planar_cwt_of_real``) exactly where the predicate says so."""
    from pycwt_torch import coherence as tco
    from pycwt_torch.coherence import _resolved_policy
    from pycwt_torch.mothers import Morlet

    monkeypatch.delenv("PYCWT_TPU_ENGINE", raising=False)
    resolved = engine or ("planar" if (device, dtype) == ("cuda", torch.float32)
                          else "xla")
    expect = resolved == "planar" and nfft != 100
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        assert tfft._planar_route(engine, device, dtype, nfft) is expect
    downcast = [w for w in seen if "float32" in str(w.message)]
    assert len(downcast) == int(expect and dtype == torch.float64)
    cfg = CWTConfig(engine=engine, dtype=dtype, pad_pow2=nfft != 100)
    name = str(dtype).rsplit(".", 1)[-1]
    assert _resolved_policy(cfg, device) == (resolved, name, int(nfft != 100))
    if device == "cuda":
        return
    calls = []
    real = fc._planar_cwt_of_real

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fc, "_planar_cwt_of_real", spy)
    n0 = ROUTE_N0[nfft]
    y = np.random.default_rng(nfft).standard_normal((2, n0))
    sc = torch.tensor([2.0, 8.0], dtype=dtype)
    kw = dict(mother=Morlet(6), nfft=nfft, dj=0.5, engine=engine)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pt.cwt_power(y[0], 1.0, dj=1.0, config=cfg, device="cpu")
        assert len(calls) == int(expect)
        tco._wct_core(torch.tensor(y[:1], dtype=dtype), torch.tensor(y[1:], dtype=dtype),
                      sc, 1.0, **kw)
        assert len(calls) == 3 * int(expect)
        tco._wct_matrix_blocks(torch.tensor(y, dtype=dtype), torch.tensor([0]),
                               torch.tensor([1]), sc, 1.0, block=1, **kw)
        assert len(calls) == 4 * int(expect)


@pytest.mark.parametrize("n0", [64, 100, 128])
@pytest.mark.parametrize("surface", ["cwt_power", "xwt_planar", "cwt_analysis"])
def test_planar_route_serves_short_records(monkeypatch, surface, n0):
    """Below the kernels' 2^8 the planar route runs their plain version (as
    wct did already) where pycwt_tpu raises: |W|² and the cross spectrum
    against the complex route in f64 at the f32 bound of
    test_cwt_power_matches_cwt_abs2."""
    from pycwt_torch.analysis import cwt_analysis

    rng = np.random.default_rng(n0)
    x = rng.standard_normal(n0)
    y = 0.5 * x + rng.standard_normal(n0)
    planar, f64 = CWTConfig(engine="planar"), CWTConfig(dtype=torch.float64)
    if surface == "cwt_power":
        got, *_ = pt.cwt_power(x, 1.0, config=planar, device="cpu")
        W, *_ = pt.cwt(x, 1.0, config=f64, device="cpu")
        ref = np.abs(W) ** 2
    elif surface == "xwt_planar":
        mag, phase, *_ = pt.xwt_planar(x, y, 1.0, config=planar, device="cpu")
        got = mag * np.exp(1j * phase)
        ref, *_ = pt.xwt(x, y, 1.0, config=f64, device="cpu")
    else:
        monkeypatch.setenv("PYCWT_TPU_ENGINE", "planar")
        res = cwt_analysis(x, 1.0, device="cpu")
        got = res.power
        W, *_ = pt.cwt(res.signal, 1.0, config=f64, device="cpu")
        ref = np.abs(W) ** 2
    assert got.shape == ref.shape and got.shape[1] == n0
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("precision", ["highest", "high", "fast"])
def test_mxu_dft_accepts_precision(precision):
    x = torch.tensor(np.random.default_rng(0).standard_normal((2, 64)))
    ref = torch.fft.fft(x, dim=-1)
    torch.testing.assert_close(mxu_dft.dft(x, precision=precision), ref)
    torch.testing.assert_close(mxu_dft.idft(ref, precision=precision).real, x)
    torch.testing.assert_close(mxu_dft.fft_of_real(x, 64, precision=precision), ref)
    re, im = mxu_dft.fft_of_real_planar(x, 64, precision=precision)
    torch.testing.assert_close(torch.complex(re, im), ref)


def test_mxu_dft_rejects_unknown_precision():
    x = torch.zeros(8)
    for call in (lambda: mxu_dft.dft(x, precision="bf16"),
                 lambda: mxu_dft.idft(x, precision="HIGHEST"),
                 lambda: mxu_dft.fft_of_real(x, 8, precision=None),
                 lambda: mxu_dft.fft_of_real_planar(x, 8, precision="x")):
        with pytest.raises(ValueError, match="precision"):
            call()


def test_fused_cwt_accepts_and_ignores_block_keywords():
    """Ablk, Cblk and interpret (the Pallas kernels' knobs) change nothing."""
    x = torch.tensor(np.random.default_rng(1).standard_normal((2, 256)),
                     dtype=torch.float32)
    sr, si = mxu_dft.fft_of_real_planar(x, 256)
    sc = torch.tensor([2.0, 4.0, 8.0])
    kw = dict(mother=pt.Morlet(6), nfft=256, dt=1.0)
    ref = fc.fused_cwt_planar(sr, si, sc, **kw)
    got = fc.fused_cwt_planar(sr, si, sc, Ablk=64, Cblk=128, interpret=True, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    W = fc.fused_cwt(torch.complex(sr, si), sc, Ablk=64, Cblk=32, interpret=False, **kw)
    assert torch.equal(W, torch.complex(*ref))


def test_cwt_power_warns_on_f64_sent_to_planar():
    """The planar route is f32: an f64 config sent there explicitly warns,
    as pycwt_tpu's _wct_core does; with the default engine f64 resolves to
    xla and nothing warns."""
    y = np.random.default_rng(2).standard_normal(256)
    with pytest.warns(UserWarning, match="float32"):
        pt.cwt_power(y, 1.0, config=CWTConfig(engine="planar", dtype=torch.float64),
                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        power, *_ = pt.cwt_power(y, 1.0, config=CWTConfig(dtype=torch.float64),
                                 device="cpu")
    assert power.dtype == np.float64
