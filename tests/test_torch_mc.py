"""The port's Monte-Carlo WCT significance (pycwt_torch/stats.py member
generators, pycwt_torch/coherence.py wct_significance and
wct_significance_batch) on the CPU in float64, against pycwt_tpu on the same
inputs: the same threefry words and normals, the same surrogates, the same
curves for the same seed, the same cache names; and mirrors of
tests/test_mc_significance.py on the port."""
import gzip
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_torch as pt
from pycwt_torch import analysis as tan
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.config import CWTConfig, DEFAULT
from pycwt_torch.sample import load
from pycwt_tpu import coherence as jco
from pycwt_tpu import stats as jst
from pycwt_tpu.config import CWTConfig as JConfig, DEFAULT as JDEFAULT
from pycwt_tpu.mothers import as_mother as jmother
from tests.conftest import rel_err

torch.set_num_threads(2)

#: the small Monte-Carlo of tests/test_mc_significance.py:73-74
SMALL = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, progress=False, device="cpu")


@pytest.fixture(autouse=True)
def f64():
    """float64 default dtype: the port's counterpart of JAX's x64 flag."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(prev)


def _words(key):
    return [int(key[0]), int(key[1])]


def _jwords(key):
    return np.asarray(jax.random.key_data(key)).tolist()


# --------------------------------------------------------------------------
# JAX's streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1, 2 ** 40 + 3])
def test_keys_match_jax(seed):
    """PRNGKey, fold_in and split give jax.random's key words bit for bit."""
    key, jkey = tst.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert _words(key) == _jwords(jkey)
    for d in (0, 1, 299, 2 ** 31 - 5):
        assert _words(tst.fold_in(key, d)) == _jwords(jax.random.fold_in(jkey, d))
    assert [_words(k) for k in tst.split(key)] == _jwords(jax.random.split(jkey))
    k0, k1 = tst.fold_in(key, torch.arange(5))
    assert [[int(a), int(b)] for a, b in zip(k0, k1)] == [
        _jwords(jax.random.fold_in(jkey, d)) for d in range(5)]


@pytest.mark.parametrize("seed", [0, 12345])
def test_normals_match_jax(seed):
    """The f64 normals of one key within 1e-13 of jax.random.normal."""
    z = tst._normal_f64(tst.PRNGKey(seed), 4096).numpy()
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4096,),
                                       jnp.float64))
    assert np.abs(z - ref).max() < 1e-13


@pytest.mark.parametrize("g", [0.0, 0.5, -0.3])
def test_rednoise_members_match_jax(g):
    idx = np.arange(5, 12)
    got = tst.rednoise_members(tst.PRNGKey(3), torch.tensor(idx), 50, g, 1.0,
                               dtype=torch.float64).numpy()
    members = jax.jit(jst.rednoise_members, static_argnums=(2, 3, 4, 5))
    ref = np.asarray(members(jax.random.PRNGKey(3), jnp.asarray(idx), 50, g, 1.0,
                             jnp.float64))
    assert got.shape == (7, 50)
    assert np.abs(got - ref).max() < 1e-12


@pytest.mark.parametrize("g, tau", [((0.5, -0.3), 8), ((0.0, 0.0), 0)])
def test_rednoise_members_pairs_match_jax(g, tau):
    slots = np.array([11, 2 ** 31 - 7])
    idx = np.arange(4)
    got = tst.rednoise_members_pairs(tst.PRNGKey(3), slots, idx, 40,
                                     torch.tensor(g), tau,
                                     dtype=torch.float64).numpy()
    pairs = jax.jit(jst.rednoise_members_pairs, static_argnums=(3, 5, 6))
    ref = np.asarray(pairs(jax.random.PRNGKey(3), jnp.asarray(slots),
                           jnp.asarray(idx), 40, jnp.asarray(g), tau, jnp.float64))
    assert got.shape == (2, 4, 40)
    assert np.abs(got - ref).max() < 1e-12


def test_member_streams_ignore_chunking():
    """Member i's surrogate is the same drawn alone or in any chunk."""
    key = tst.PRNGKey(9)
    whole = tst.rednoise_members(key, torch.arange(10), 30, 0.6, dtype=torch.float64)
    part = tst.rednoise_members(key, torch.arange(6, 9), 30, 0.6, dtype=torch.float64)
    assert torch.equal(whole[6:9], part)


# --------------------------------------------------------------------------
# Cache names and the same-seed curves
# --------------------------------------------------------------------------

_CONFIGS = {
    "default": (DEFAULT, JDEFAULT),
    "planar32": (CWTConfig(engine="planar", dtype=torch.float32),
                 JConfig(engine="planar", dtype="float32")),
    "mxu32_nopad": (CWTConfig(engine="mxu", dtype=torch.float32, pad_pow2=False),
                    JConfig(engine="mxu", dtype="float32", pad_pow2=False)),
}


@pytest.mark.parametrize("cfg", sorted(_CONFIGS))
@pytest.mark.parametrize("alpha", [0.02, 0.3, -0.1])
@pytest.mark.parametrize("count_seed", [(300, 0), (50, 3)])
def test_sig_cache_name_matches_jax(cfg, alpha, count_seed):
    """Byte-equal file names and headers, so the two packages share curves
    (α = 0.3 folds to the reference's "nan" name)."""
    tcfg, jcfg = _CONFIGS[cfg]
    args = (alpha, 0.1, 1 / 12, 0.48, 0.25, 75)
    got = tco._sig_cache_name(*args, pt.Morlet(6), *count_seed, tcfg)
    ref = jco._sig_cache_name(*args, jmother("morlet"), *count_seed, jcfg)
    assert got == ref
    assert tco._sig_cfg_tag(tcfg) == jco._sig_cfg_tag(jcfg)


def test_sig_cache_name_resolves_on_the_card():
    """On a CUDA device f32 resolves to planar and f64 to xla (no card is
    needed to name the file)."""
    args = (0.3, 0.4, 1 / 12, 2.0, 1.0, 40, pt.Morlet(6), 300, 0)
    bare = tco._sig_cache_name(*args, DEFAULT)
    assert "_cfg" not in bare
    assert tco._sig_cache_name(*args, DEFAULT, device="cuda") == bare
    f32 = CWTConfig(dtype=torch.float32)
    assert tco._sig_cache_name(*args, f32, device="cuda") == bare + "_cfgplanar-float32-p1"
    assert tco._sig_cache_name(*args, f32) == bare + "_cfgxla-float32-p1"


def test_wct_significance_matches_jax_same_seed():
    """The same seed draws the same members: the port's curve is
    pycwt_tpu's within 1e-9 (acceptance bound)."""
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=12, progress=False,
              cache=False, seed=4)
    got = tco.wct_significance(0.5, 0.6, mc_batch=5, device="cpu", **kw)
    ref = jco.wct_significance(0.5, 0.6, mc_batch=5, **kw)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 1e-9


def test_wct_significance_batch_matches_jax_same_seed():
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=12, progress=False,
              cache=False, seed=4)
    got = tco.wct_significance_batch([0.0, 0.6], [0.0, 0.5], mc_batch=5,
                                     device="cpu", **kw)
    ref = jco.wct_significance_batch([0.0, 0.6], [0.0, 0.5], mc_batch=5, **kw)
    assert got.shape == (2, 8)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 1e-9


def test_histogram_counts_outside_coi_only():
    """floor(R²·1000) clipped to [0, 999], outside the COI, valid members."""
    R2 = torch.tensor([[[0.0, 0.4999, 1.0, 2.0, np.nan, np.inf]],
                       [[0.5, 0.5, -1.0, 0.25, -np.inf, 0.3]]])
    oc = torch.tensor([[True, True, True, False, True, True]])
    h = tco._histogram(R2, oc)
    assert h.dtype == torch.int64 and h.shape == (1, tco.NBINS)
    want = np.zeros(tco.NBINS, np.int64)
    for b in (0, 499, 999, 0, 999, 500, 500, 0, 0, 300):
        want[b] += 1
    np.testing.assert_array_equal(h[0].numpy(), want)
    h1 = tco._histogram(R2[None], oc, valid=torch.tensor([True, False]))
    assert h1.shape == (1, 1, tco.NBINS) and int(h1.sum()) == 5


# --------------------------------------------------------------------------
# Mirrors of tests/test_mc_significance.py:24-230 (single pair)
# --------------------------------------------------------------------------

def test_mc_golden_bands_through_wct_analysis(golden):
    """wct_analysis(sig=True) on JAO/JBaltic fits the MC golden's own
    inputs (al1, al2, s0, J); at 300 members and seed 7 its curve holds the
    bands of tests/test_mc_significance.py:32-41, its WCT the golden's 1e-10."""
    g = golden("wct_sig_jao_jbaltic")
    jao, jba = load("jao"), load("jbaltic")
    n = min(jao.values.size, jba.values.size)
    res = tan.wct_analysis(jao.values[:n], jba.values[:n], jao.dt,
                           significance_level=0.95, sig=True, mc_count=300,
                           seed=7, mc_batch=60, cache=False, progress=False,
                           device="cpu")
    np.testing.assert_allclose(res["WCT"], golden("figure_jao_jbaltic")["wct"],
                               rtol=1e-10)
    sig95, ref = res["sig95"], g["sig95"]
    assert sig95.shape == ref.shape
    assert np.array_equal(np.isnan(sig95), np.isnan(ref))
    assert np.array_equal(sig95 == 0, ref == 0)
    valid = np.isfinite(ref) & (ref != 0)
    diff = np.abs(sig95[valid] - ref[valid])
    assert diff.max() < 0.06, f"max |Δsig95| = {diff.max():.4f}"
    assert diff.mean() < 0.02, f"mean |Δsig95| = {diff.mean():.4f}"


def test_mc_deterministic_given_seed():
    kw = dict(SMALL, mc_count=20, cache=False, seed=3)
    a = tco.wct_significance(0.3, 0.4, **kw)
    b = tco.wct_significance(0.3, 0.4, **kw)
    np.testing.assert_array_equal(a, b)


def test_mc_cache_roundtrip(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, mc_count=10, cache=True, seed=0)
    a = tco.wct_significance(0.5, 0.6, **kw)
    files = list(tmp_path.iterdir())
    # one entry, no temporary file left behind
    assert len(files) == 1 and files[0].name.startswith("wct_sig_")
    assert files[0].name.endswith(".gz") and ".tmp" not in files[0].name
    b = tco.wct_significance(0.5, 0.6, **kw)
    assert "loaded from cache" in capsys.readouterr().out
    np.testing.assert_allclose(a, b, atol=1e-12)


def test_mc_checkpoint_exact_resume(tmp_path):
    """A run resumed from a mid-flight checkpoint equals an uninterrupted
    one (global-index member keying)."""
    kw = dict(SMALL, mc_count=12, cache=False, seed=4, mc_batch=4)
    full = tco.wct_significance(0.5, 0.6, **kw)
    ck = str(tmp_path / "mc.ckpt")
    tco.wct_significance(0.5, 0.6, checkpoint=ck, **kw)
    with np.load(ck) as z:
        assert int(z["done"]) == 12
        meta = np.asarray(z["meta"])
    # a truly partial checkpoint: the first 8 members only
    n, sj, outsidecoi, _, _ = tco._surrogate_grid(1.0, 1 / 4, 2.0, 7, pt.Morlet(6))
    key = tst.PRNGKey(4)
    wlc8 = sum(tco._mc_histogram_chunk(
        key, start, torch.tensor(sj), torch.tensor(outsidecoi), 1.0,
        mother=pt.Morlet(6), nfft=DEFAULT.fft_length(n), dj=1 / 4, batch=4,
        n=n, al1=0.5, al2=0.6) for start in (0, 4)).numpy().astype(np.float64)
    with open(ck, "wb") as f:
        np.savez(f, meta=meta, wlc=wlc8, done=np.int64(8))
    resumed = tco.wct_significance(0.5, 0.6, checkpoint=ck, **kw)
    valid = np.isfinite(full)
    np.testing.assert_array_equal(resumed[valid], full[valid])


def test_mc_checkpoint_rejects_different_wavelet(tmp_path):
    kw = dict(SMALL, mc_count=8, cache=False, seed=5, mc_batch=4)
    ck = str(tmp_path / "mix.ckpt")
    tco.wct_significance(0.5, 0.6, wavelet="morlet", checkpoint=ck, **kw)
    clean_paul = tco.wct_significance(0.5, 0.6, wavelet="paul", **kw)
    resumed_paul = tco.wct_significance(0.5, 0.6, wavelet="paul", checkpoint=ck,
                                        **kw)
    valid = np.isfinite(clean_paul)
    np.testing.assert_array_equal(resumed_paul[valid], clean_paul[valid])


def test_mc_checkpoint_extends_mc_count(tmp_path):
    kw = dict(SMALL, cache=False, seed=6, mc_batch=4)
    full12 = tco.wct_significance(0.5, 0.6, mc_count=12, **kw)
    ck = str(tmp_path / "ext.ckpt")
    tco.wct_significance(0.5, 0.6, mc_count=8, checkpoint=ck, **kw)
    assert int(np.load(ck)["done"]) == 8
    extended = tco.wct_significance(0.5, 0.6, mc_count=12, checkpoint=ck, **kw)
    assert int(np.load(ck)["done"]) == 12
    valid = np.isfinite(full12)
    np.testing.assert_array_equal(extended[valid], full12[valid])


def test_mc_checkpoint_truncated_starts_afresh(tmp_path):
    """A checkpoint cut off mid-write is ignored, not an error."""
    kw = dict(SMALL, mc_count=8, cache=False, seed=5, mc_batch=4)
    ck = tmp_path / "cut.ckpt"
    ck.write_bytes(b"PK\x03\x04 truncated")
    np.testing.assert_array_equal(
        tco.wct_significance(0.5, 0.6, checkpoint=str(ck), **kw),
        tco.wct_significance(0.5, 0.6, **kw))


def test_mc_fused_dispatch_matches_chunked(tmp_path):
    """Chunks accumulated on the device equal the per-chunk checkpoint loop."""
    kw = dict(SMALL, mc_count=12, cache=False, seed=4, mc_batch=4)
    fused = tco.wct_significance(0.5, 0.6, **kw)
    chunked = tco.wct_significance(0.5, 0.6, checkpoint=str(tmp_path / "c.ckpt"),
                                   **kw)
    valid = np.isfinite(fused)
    np.testing.assert_array_equal(fused[valid], chunked[valid])


def test_mc_cache_key_isolates_config(tmp_path, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, mc_count=8, seed=1, mc_batch=4, cache=True)
    tco.wct_significance(0.5, 0.6, **kw)
    tco.wct_significance(0.5, 0.6, config=CWTConfig(engine="mxu"), **kw)
    names = sorted(f.name for f in tmp_path.iterdir())
    assert len(names) == 2, names
    assert any("_cfgmxu-" in n for n in names), names


def test_mc_cache_key_isolates_seed_and_count(tmp_path, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, cache=True)
    s_a = tco.wct_significance(0.5, 0.6, mc_count=8, seed=1, mc_batch=4, **kw)
    s_b = tco.wct_significance(0.5, 0.6, mc_count=16, seed=9, mc_batch=4, **kw)
    valid = np.isfinite(s_a) & np.isfinite(s_b)
    assert valid.any()
    assert not np.array_equal(s_a[valid], s_b[valid])
    s_b2 = tco.wct_significance(0.5, 0.6, mc_count=16, seed=9, mc_batch=4, **kw)
    np.testing.assert_array_equal(s_b[valid], s_b2[valid])


def test_mc_auto_batch_model():
    """The port's bytes model (4·(10·S·nfft + 9·S·n) bytes a member, 25e9
    budget, cap 1024, balanced chunks)."""
    assert tco._mc_auto_batch(300, 76, 1024, 885) == 300      # the golden shape
    assert tco._mc_auto_batch(10_000, 76, 1024, 885) == 1000  # 10 equal chunks
    assert tco._mc_auto_batch(10_000, 400, 65536, 60000) == 13
    assert tco._mc_auto_batch(300, 119, 16384, 10543) == 150  # 2 chunks of 211 -> 150
    assert tco._mc_auto_batch(10 ** 6, 8, 256, 200) == 1024   # tiny: ceiling
    assert tco._mc_auto_batch(50, 8, 256, 200, budget_bytes=1.0) == 1
    assert tco._mc_member_bytes(76, 1024, 885) == 5_534_320


def test_mc_auto_batch_default_matches_explicit():
    kw = dict(SMALL, mc_count=12, cache=False, seed=3)
    s_auto = tco.wct_significance(0.5, 0.6, mc_batch=None, **kw)
    s_explicit = tco.wct_significance(0.5, 0.6, mc_batch=5, **kw)
    np.testing.assert_array_equal(s_auto, s_explicit)


def test_truncated_cache_entry_is_a_miss(tmp_path, monkeypatch):
    """An unreadable entry (a truncated .gz, garbage) is recomputed and
    rewritten, not raised (deviation from pycwt_tpu, which raises)."""
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, mc_count=8, seed=2, mc_batch=4, cache=True)
    good = tco.wct_significance(0.5, 0.6, **kw)
    (path,) = tmp_path.iterdir()
    for bad in (path.read_bytes()[:20], gzip.compress(b"not a curve\n")):
        path.write_bytes(bad)
        again = tco.wct_significance(0.5, 0.6, **kw)
        np.testing.assert_array_equal(again, good)
        np.testing.assert_array_equal(np.loadtxt(path), good)


# --------------------------------------------------------------------------
# Mirrors of tests/test_mc_significance.py:232-484 (batched)
# --------------------------------------------------------------------------

def test_wct_significance_batch_chunking_invariant():
    kw = dict(SMALL, mc_count=12, cache=False, seed=2)
    a = tco.wct_significance_batch([0.4, 0.7], [0.5, 0.2], mc_batch=3, **kw)
    b = tco.wct_significance_batch([0.4, 0.7], [0.5, 0.2], mc_batch=6, **kw)
    assert a.shape == (2, 8)
    np.testing.assert_array_equal(a, b)


def test_wct_significance_batch_agrees_with_single_pair():
    kw = dict(SMALL, cache=False)
    batch = tco.wct_significance_batch([0.0, 0.6], [0.0, 0.5], mc_count=64,
                                       seed=3, mc_batch=16, **kw)
    for p, (a1_, a2_) in enumerate([(0.0, 0.0), (0.6, 0.5)]):
        single = tco.wct_significance(a1_, a2_, mc_count=64, seed=4,
                                      mc_batch=16, **kw)
        valid = np.isfinite(single) & (single != 0) & np.isfinite(batch[p])
        assert valid.any()
        assert np.abs(batch[p][valid] - single[valid]).max() < 0.25


def test_wct_significance_batch_seeds_single_pair_cache(tmp_path, monkeypatch,
                                                        capsys):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, mc_count=8, seed=6)
    batch = tco.wct_significance_batch([0.3], [0.4], cache=True, mc_batch=4, **kw)
    got = tco.wct_significance(0.3, 0.4, cache=True, **kw)
    assert "loaded from cache" in capsys.readouterr().out
    np.testing.assert_allclose(got, batch[0], atol=1e-12)


@pytest.mark.parametrize("al1, match", [([0.5, np.nan], "non-finite"),
                                        ([0.5, 1.0], "alpha")])
def test_wct_significance_batch_rejects_bad_alpha(al1, match):
    with pytest.raises(ValueError, match=match):
        tco.wct_significance_batch(al1, [0.4, 0.3], mc_count=8, cache=False,
                                   **SMALL)


def test_wct_significance_batch_clamps_oversized_mc_batch():
    kw = dict(SMALL, mc_count=6, cache=False, seed=2)
    a = tco.wct_significance_batch([0.4], [0.5], mc_batch=1000, **kw)
    b = tco.wct_significance_batch([0.4], [0.5], mc_batch=6, **kw)
    np.testing.assert_array_equal(a, b)


def test_wct_significance_batch_cache_round_trip(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, mc_count=8, seed=7, cache=True, mc_batch=4, progress=True)
    a = tco.wct_significance_batch([0.3, 0.6], [0.4, 0.2], **kw)
    b = tco.wct_significance_batch([0.3, 0.6], [0.4, 0.2], **kw)
    assert "loaded from cache" in capsys.readouterr().out
    np.testing.assert_allclose(b, a, atol=1e-12)


def test_wct_significance_batch_pair_blocking_invariant():
    kw = dict(SMALL, mc_count=8, cache=False, seed=8, mc_batch=4)
    al1 = [0.2, 0.4, 0.6, 0.7, 0.1]
    al2 = [0.3, 0.5, 0.2, 0.6, 0.4]
    a = tco.wct_significance_batch(al1, al2, pair_block=5, **kw)
    b = tco.wct_significance_batch(al1, al2, pair_block=2, **kw)  # ragged tail
    np.testing.assert_array_equal(a, b)


def test_wct_significance_batch_exact_count_invariance():
    kw = dict(SMALL, mc_count=13, cache=False, seed=2)
    a = tco.wct_significance_batch([0.4], [0.5], mc_batch=13, **kw)
    b = tco.wct_significance_batch([0.4], [0.5], mc_batch=5, **kw)   # 15 drawn
    c = tco.wct_significance_batch([0.4], [0.5], mc_batch=4, **kw)   # 16 drawn
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


def test_wct_significance_batch_dedups_equivalent_nulls():
    kw = dict(SMALL, mc_count=8, cache=False, seed=5, mc_batch=4)
    al1 = [0.3, 0.5, 0.3004, 0.3]
    al2 = [0.5, 0.3, 0.5, 0.5]
    sig = tco.wct_significance_batch(al1, al2, **kw)
    np.testing.assert_array_equal(sig[0], sig[1])  # unordered symmetry
    np.testing.assert_array_equal(sig[0], sig[2])  # rounds to the same key
    np.testing.assert_array_equal(sig[0], sig[3])  # exact duplicate
    sig0 = tco.wct_significance_batch(al1, al2, alpha_quant=0, **kw)
    np.testing.assert_array_equal(sig0[0], sig0[1])
    np.testing.assert_array_equal(sig0[0], sig0[3])
    assert np.nanmax(np.abs(sig0[0] - sig0[2])) > 0


def test_wct_significance_batch_dedup_cache_state_independent():
    kw = dict(SMALL, mc_count=8, cache=False, seed=5, mc_batch=4)
    alone = tco.wct_significance_batch([0.6], [0.2], **kw)
    in_batch = tco.wct_significance_batch([0.1, 0.6, 0.4], [0.3, 0.2, 0.4], **kw)
    np.testing.assert_array_equal(alone[0], in_batch[1])


def test_wct_significance_batch_partial_cache_hit(tmp_path, monkeypatch):
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    kw = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7, mc_count=8, seed=6, device="cpu")
    sentinel = np.linspace(0.123, 0.789, 8)
    name = tco._sig_cache_name(0.3, 0.4, 1 / 4, 2.0, 1.0, 7, pt.Morlet(6), 8, 6,
                               DEFAULT)
    np.savetxt(f"{tmp_path}/{name}.gz", sentinel)
    sig = tco.wct_significance_batch([0.3, 0.6], [0.4, 0.2], cache=True,
                                     progress=False, mc_batch=4, **kw)
    np.testing.assert_allclose(sig[0], sentinel, atol=1e-12)
    assert np.isfinite(sig[1][1:]).any() and not np.allclose(sig[1], sig[0])
    fresh = tco.wct_significance_batch([0.6], [0.2], cache=False, progress=False,
                                       mc_batch=4, **kw)
    np.testing.assert_array_equal(sig[1], fresh[0])


def test_sig_cache_name_keys_on_resolved_policy():
    m = pt.Morlet(6)
    args = (0.3, 0.4, 1 / 12, 2.0, 1.0, 40, m, 300, 0)
    base = tco._sig_cache_name(*args, DEFAULT)
    assert "_cfg" not in base
    planar32 = tco._sig_cache_name(
        *args, CWTConfig(engine="planar", dtype=torch.float32))
    assert planar32.startswith(base) and "_cfgplanar-float32" in planar32
    planar64 = tco._sig_cache_name(
        *args, CWTConfig(engine="planar", dtype=torch.float64))
    assert planar64 != planar32


def test_wct_significance_batch_auto_quant_scales_with_mc_count():
    kw = dict(SMALL, cache=False, seed=3)
    coarse = tco.wct_significance_batch([0.44, 0.46], [0.3, 0.3], mc_count=8,
                                        mc_batch=4, **kw)
    np.testing.assert_array_equal(coarse[0], coarse[1])    # q = 0.05: shared
    fine = tco.wct_significance_batch([0.44, 0.46], [0.3, 0.3], mc_count=100,
                                      mc_batch=100, **kw)
    np.testing.assert_array_equal(fine[0], fine[1])        # 0.0866 -> 0.05
    very_fine = tco.wct_significance_batch([0.44, 0.46], [0.3, 0.3],
                                           mc_count=12000, mc_batch=3000, **kw)
    assert np.nanmax(np.abs(very_fine[0] - very_fine[1])) > 0   # q = 0.01


def test_wct_significance_batch_boundary_alpha_does_not_round_to_one():
    kw = dict(SMALL, mc_count=4, cache=False, seed=1, mc_batch=4)
    sig = tco.wct_significance_batch([0.99, -0.99], [0.5, 0.5], **kw)
    assert np.isfinite(sig[:, 1:5]).any()
    sig2 = tco.wct_significance_batch([0.98, -0.99], [0.5, 0.5], **kw)
    np.testing.assert_array_equal(sig[0], sig2[0])


def test_sig_cache_rejects_cross_policy_entries(tmp_path):
    curve = np.linspace(0, 1, 9)
    path = str(tmp_path / "wct_sig_test.gz")
    tco._sig_cache_write(path, curve, DEFAULT)
    np.testing.assert_allclose(tco._sig_cache_read(path, DEFAULT), curve)
    other = CWTConfig(engine="mxu", dtype=torch.float32)
    assert tco._sig_cfg_tag(other) != tco._sig_cfg_tag(DEFAULT)
    with pytest.raises(OSError, match="different resolved"):
        tco._sig_cache_read(path, other)
    assert tco._sig_cache_lookup(path, other) is None
    np.savetxt(path, curve)                      # headerless: the reference's
    np.testing.assert_allclose(tco._sig_cache_read(path, DEFAULT), curve)
    np.testing.assert_allclose(tco._sig_cache_read(path, other), curve)
    # and pycwt_tpu reads the port's entries (same header)
    tco._sig_cache_write(path, curve, DEFAULT)
    np.testing.assert_allclose(jco._sig_cache_read(path, JDEFAULT), curve)


def test_batch_writes_each_cache_name_once(tmp_path, monkeypatch):
    """Every α > 0.25 folds to one "nan" name: one write per call, holding
    the last such pair's curve, as pycwt_tpu's per-pair writes leave it
    (deviation: pycwt_tpu writes the file once per pair)."""
    monkeypatch.setenv("PYCWT_TPU_CACHE_DIR", str(tmp_path))
    writes = []
    real_write = tco._sig_cache_write
    monkeypatch.setattr(tco, "_sig_cache_write",
                        lambda path, *a, **k: (writes.append(path),
                                               real_write(path, *a, **k)))
    kw = dict(SMALL, mc_count=8, seed=2, mc_batch=4, cache=True)
    sig = tco.wct_significance_batch([0.3, 0.4, 0.01], [0.6, 0.7, 0.02], **kw)
    assert len(writes) == len(set(writes)) == 2
    (nan_path,) = [p for p in writes if "nan" in os.path.basename(p)]
    np.testing.assert_array_equal(np.loadtxt(nan_path), sig[1])


def test_wct_significance_batch_mesh_raises():
    """mesh= takes a DeviceMesh of pycwt_torch.parallel (the sharded runs
    are in tests/test_torch_sharding.py and tests/test_torch_multihost.py);
    anything else raises before any work."""
    with pytest.raises(TypeError, match="mesh must be a DeviceMesh"):
        tco.wct_significance_batch([0.3], [0.4], mesh=object(), **SMALL)


def test_wct_sig_true_returns_significance_curve():
    """wct(sig=True) forwards kwargs and device to wct_significance."""
    rng = np.random.default_rng(5)
    y1 = rng.standard_normal(64)
    y2 = 0.5 * y1 + rng.standard_normal(64)
    kw = dict(mc_count=6, seed=2, cache=False, progress=False, mc_batch=3)
    WCT, _, _, _, sig = pt.wct(y1, y2, 1.0, dj=1 / 4, device="cpu", **kw)
    a1, a2 = pt.ar1(y1)[0], pt.ar1(y2)[0]
    s0 = 2 / pt.Morlet(6).flambda()
    J = int(np.round(np.log2(64 / s0) / (1 / 4)))
    ref = tco.wct_significance(a1, a2, 1.0, 1 / 4, s0, J, device="cpu", **kw)
    assert sig.shape == (J + 1,) == (WCT.shape[0],)
    np.testing.assert_array_equal(sig, ref)
    assert rel_err(WCT, pt.wct(y1, y2, 1.0, dj=1 / 4, sig=False, device="cpu")[0]) == 0
