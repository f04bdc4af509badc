"""The distributed pencil FFT (``pycwt_torch/parallel/dist_fft.py``) on 8
gloo ranks on the CPU, mirroring ``tests/test_dist_fft.py``: equality with
the global FFT, forward and inverse, real, complex and planar inputs, the
exact spectral CWT against the global transform, the O(N/D) layout, and
``pycwt_tpu``'s sharded results on its 8-device CPU mesh.  One 8-rank job
(``test_torch_parallel_support.job_dist_fft``) serves every test."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pycwt_tpu as wt
from pycwt_tpu.parallel import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from pycwt_tpu.parallel import dist_fft as jdf

import pycwt_torch as pt
from pycwt_torch.transform import cwt_batch

import test_torch_parallel_support as sup
from test_torch_parallel_support import assemble

NS = [1 << 8, 1 << 10, 1 << 13]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return sup.launch("dist_fft", 8, str(tmp_path_factory.mktemp("dist_fft")))


@pytest.fixture(scope="module")
def inp():
    return sup.dist_fft_inputs()


@pytest.fixture(scope="module")
def jmesh8():
    return jmake_mesh(JMeshSpec(data=8), devices=jax.devices()[:8])


def _global_w(x, scales, dt):
    """The single-device global transform in f64 (pow-2 N: no padding)."""
    from pycwt_torch.config import CWTConfig

    W, _ = cwt_batch(torch.as_tensor(x)[None], torch.as_tensor(scales), dt,
                     mother=pt.Morlet(6), nfft=len(x),
                     config=CWTConfig(dtype=torch.float64))
    return W[0].numpy()


def test_ranks_import_no_jax(ranks):
    assert all(bool(r["imports_clean"]) for r in ranks)


@pytest.mark.parametrize("N", NS)
def test_sharded_dft_matches_fft_real(ranks, inp, N):
    out = assemble(ranks, f"dft/real{N}")
    np.testing.assert_allclose(out, np.fft.fft(inp[f"real{N}"]), rtol=1e-9, atol=1e-9 * N)


@pytest.mark.parametrize("N", NS)
def test_sharded_dft_matches_jax(ranks, inp, jmesh8, N):
    ref = np.asarray(jdf.sharded_dft(jmesh8, jnp.asarray(inp[f"real{N}"])))
    np.testing.assert_allclose(assemble(ranks, f"dft/real{N}"), ref, rtol=1e-9, atol=1e-9 * N)


@pytest.mark.parametrize("N", NS)
def test_sharded_dft_output_sharding(ranks, N):
    """Output stays sharded over 'data': no rank holds the full spectrum."""
    assert sup.local_shapes(ranks, f"dft/real{N}") == {(N // 8,)}


def test_sharded_dft_matches_fft_complex(ranks, inp):
    np.testing.assert_allclose(assemble(ranks, "dft/complex"), np.fft.fft(inp["complex"]),
                               rtol=1e-9, atol=1e-9 * 1024)


def test_sharded_idft_roundtrip(ranks, inp):
    back = assemble(ranks, "dft/roundtrip")
    np.testing.assert_allclose(back.real, inp["roundtrip"], atol=1e-10)
    np.testing.assert_allclose(back.imag, 0, atol=1e-10)


def test_sharded_dft_layout(ranks):
    assert sup.local_shapes(ranks, "dft/layout") == {(1024 // 8,)}


def test_sharded_dft_f32(ranks, inp):
    out = assemble(ranks, "dft/f32")
    assert out.dtype == np.complex64
    ref = np.fft.fft(inp["f32"].astype(np.float64))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-4


def test_sharded_dft_rejects_bad_sizes(ranks):
    """Every rank raises before the first all-to-all, and the next
    collective still finds every rank."""
    for r in ranks:
        assert "distributed DFT needs pow-2 N, got 1000" in str(r["dft/non_pow2"])
        assert "too small to pencil-decompose over 8 devices" in str(r["dft/too_small"])
    assert [float(r["after_errors"]) for r in ranks] == [8.0] * 8


def test_sharded_cwt_spectral_exact_vs_global(ranks, inp):
    """The spectral sequence-parallel CWT equals the global transform to
    round-off at every scale, the near-Nyquist ones included."""
    sc = sup.spectral_scales(1.0, pt.Morlet(6), "exact")
    W = assemble(ranks, "spectral/exact")
    W_ref = _global_w(inp["spectral"], sc, 1.0)
    assert np.abs(W - W_ref).max() / np.abs(W_ref).max() < 1e-10


def test_sharded_cwt_spectral_matches_jax(ranks, inp, jmesh8):
    """pycwt_tpu's spectral CWT on the same input, at the port's f64 bound
    for cwt_batch against pycwt_tpu (1e-12 of max|W|)."""
    sc = sup.spectral_scales(1.0, pt.Morlet(6), "exact")
    ref = np.asarray(jdf.sharded_cwt_spectral(jmesh8, jnp.asarray(inp["spectral"]),
                                              jnp.asarray(sc), 1.0, mother=wt.Morlet(6)))
    W = assemble(ranks, "spectral/exact")
    assert np.abs(W - ref).max() < 1e-12 * np.abs(ref).max()


def test_sharded_cwt_spectral_sharding_layout(ranks):
    W = assemble(ranks, "spectral/layout")
    assert W.shape == (2, 1024)
    assert sup.local_shapes(ranks, "spectral/layout") == {(2, 1024 // 8)}


def test_sharded_dft_planar_matches_complex(ranks, inp):
    """The planar pencil DFT, real and complex inputs as planes."""
    N = 1024
    ref = np.fft.fft(inp["planar_re"])
    np.testing.assert_allclose(assemble(ranks, "planar/real_re"), ref.real, atol=1e-9 * N)
    np.testing.assert_allclose(assemble(ranks, "planar/real_im"), ref.imag, atol=1e-9 * N)
    ref2 = np.fft.fft(inp["planar_re"] + 1j * inp["planar_im"])
    np.testing.assert_allclose(assemble(ranks, "planar/complex_re"), ref2.real, atol=1e-9 * N)
    np.testing.assert_allclose(assemble(ranks, "planar/complex_im"), ref2.imag, atol=1e-9 * N)


def test_sharded_dft_planar_output_sharding(ranks):
    for name in ("planar/layout_re", "planar/layout_im"):
        assert sup.local_shapes(ranks, name) == {(128,)}


def test_sharded_cwt_spectral_planar_matches_complex(ranks, inp, jmesh8):
    """Planar spectral CWT == complex spectral CWT == the global transform,
    and pycwt_tpu's planar result."""
    W = assemble(ranks, "spectral_planar/complex")
    wr, wi = assemble(ranks, "spectral_planar/re"), assemble(ranks, "spectral_planar/im")
    scale = np.abs(W).max()
    np.testing.assert_allclose(wr, W.real, atol=1e-10 * scale)
    np.testing.assert_allclose(wi, W.imag, atol=1e-10 * scale)
    for name in ("spectral_planar/re", "spectral_planar/im"):
        assert sup.local_shapes(ranks, name) == {(4, 2048 // 8)}
    sc = sup.spectral_scales(0.5, pt.Morlet(6), "planar")
    W_ref = _global_w(inp["spectral_planar"], sc, 0.5)
    assert np.abs(W - W_ref).max() / np.abs(W_ref).max() < 1e-10
    jr, _ = jdf.sharded_cwt_spectral_planar(jmesh8, jnp.asarray(inp["spectral_planar"]),
                                            jnp.asarray(sc), 0.5, mother=wt.Morlet(6))
    np.testing.assert_allclose(wr, np.asarray(jr), atol=1e-12 * scale)


def test_sharded_cwt_spectral_planar_outputs_are_real(ranks):
    """The planar pipeline's outputs and their shards are real float
    tensors (the counterpart of JAX's no-complex-in-HLO check)."""
    for r in ranks:
        assert r["spectral_planar/dtypes"].tolist() == ["torch.float32"] * 4
        for name in ("spectral_planar/re", "spectral_planar/im", "planar/real_re"):
            assert not np.iscomplexobj(r[name])
