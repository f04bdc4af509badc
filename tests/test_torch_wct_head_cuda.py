"""The coherence head kernel on the card (``csrc/wct_head.cu``,
``ops/wct_head.py``) against the torch head on the card, bit for bit: the
two fields and the cross planes at a Monte-Carlo chunk's cut (2 × 9 rows of
110 scales × 6302 samples trimmed from pitch 8192), an overlap-save chunk's
(64 scales × 2^16, whole rows), odd n at one scale, the real and
imaginary views of a complex W (the planar route's plain transform below
nfft 2^8) and transposed planes, with zeros, NaN, ±inf and subnormal values among the planes;
then, through the kernel and through the torch head, the counts of
``_mc_histogram_run_pairs``, ``_wct_core``'s planar WCT, phase and W12 (at
nfft 128 too), ``wct`` with its null on a pair of 100 samples, and
``wct_overlap_planar``'s maps at 2^20; the wrapper's refusals.  They need
an NVIDIA card, so they skip where there is none; ``python -m pytest --noconftest
tests/test_torch_wct_head_cuda.py`` on the card runs them."""
import warnings

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.ops import overlap as tov
from pycwt_torch.ops import wct_head
from pycwt_torch.utils import profiling

M6 = pt.Morlet(6)
#: the 32-station network's Monte-Carlo grid (S = 110, n = 6302)
NET = dict(dt=0.25, dj=1 / 12, s0=0.48400665459719555, J=109)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _planes(lead, S, n, pitch, seed, dev):
    """Four random planes ``(*lead, S, n)`` on the card, the trimmed views
    of width-``pitch`` rows, with zeros, NaN, ±inf and subnormal values
    (and products of them that underflow) among them."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((4, *lead, S, pitch), generator=g)
    flat = full.view(4, -1)
    at = torch.randperm(flat.shape[1], generator=g)[:4000].tolist()
    values = [0.0, -0.0, float("nan"), float("inf"), -float("inf"), 1e-39, -3e-42,
              2e-20, -1e-19, 3e38]
    for k, i in enumerate(at):
        flat[k % 4, i] = values[k % len(values)]
    full = full.to(dev)[..., :n]
    return (full[0], full[1]), (full[2], full[3])


def _scales(S, dev):
    return (torch.rand(S, generator=torch.Generator().manual_seed(S)) * 60 + 0.4).to(dev)


def _same(a, b):
    """Bit for bit: the same dtype and shape, NaN at the same places and
    every other float's bits equal (so -0.0 is not 0.0)."""
    a, b = (torch.view_as_real(t) if t.is_complex() else t for t in (a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    bits = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.masked_fill(nan, 0).contiguous().view(bits),
        b.masked_fill(nan, 0).contiguous().view(bits))


def _complex_views(lead, S, n, nfft, seed, dev):
    """The real and imaginary views of two complex W ``(*lead, S, nfft)``
    on the card, trimmed to ``n``: points two floats apart."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((2, *lead, S, nfft), generator=g, dtype=torch.complex64)
    W.view(torch.float32).view(-1)[:40:3] = float("nan")
    W = W.to(dev)[..., :n]
    return (W[0].real, W[0].imag), (W[1].real, W[1].imag)


@pytest.mark.parametrize("layout", [
    ((2, 9), 110, 6302, 8192),     # a Monte-Carlo chunk's cut
    ((), 64, 1 << 16, 1 << 16),    # an overlap-save chunk's cut, whole rows
    ((3,), 1, 885, 1024),          # odd n, one scale
    ((7,), 1, 147, 147),
    ((2,), 5, 1030, 1031),         # a pitch that is no multiple of 4
    ((3,), 76, 100, "complex"),    # complex views of rows of 128, trimmed
    ((2,), 4, 20, "transposed"),   # scales consecutive, points 4 floats apart
], ids=["mc-chunk", "overlap-chunk", "odd-one-scale", "odd-whole", "odd-pitch",
        "complex-views", "transposed"])
@pytest.mark.parametrize("cross", [True, False], ids=["cross", "fields"])
def test_the_kernels_fields_are_the_torch_heads(cuda, layout, cross):
    lead, S, n, pitch = layout
    if pitch == "complex":
        w1, w2 = _complex_views(lead, S, n, 128, seed=n, dev=cuda)
    elif pitch == "transposed":
        full = torch.randn((4, *lead, n, S), device=cuda).transpose(-1, -2)
        w1, w2 = (full[0], full[1]), (full[2], full[3])
    else:
        w1, w2 = _planes(lead, S, n, pitch, seed=n, dev=cuda)
    sc = _scales(S, cuda)
    launches = wct_head.LAUNCHES["wct_fields_head"]
    got = wct_head.fields_head(*w1, *w2, sc, cross=cross)
    assert wct_head.LAUNCHES["wct_fields_head"] == launches + 1
    want = tco._torch_head(w1, w2, sc, cross=cross)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        assert a.is_contiguous() and _same(a, b)
    if cross:
        for a, b in zip(got[2], want[2]):
            assert a.is_contiguous() and _same(a, b)
    else:
        assert got[2] is None


def _torch_head_only(monkeypatch):
    monkeypatch.setattr(tco, "_head_on_card", lambda w1, w2, scales: False)


def test_the_network_nulls_are_counted_alike(cuda, monkeypatch):
    """``_mc_histogram_run_pairs`` at the network's grid (three nulls, an
    overdrawn last chunk) through the head kernel and the torch head."""
    n, sj, oc, _, _ = tco._surrogate_grid(NET["dt"], NET["dj"], NET["s0"], NET["J"], M6)
    args = (tst.PRNGKey(78, device=cuda), torch.tensor(sj, dtype=torch.float32, device=cuda),
            torch.tensor(oc, device=cuda), torch.tensor([4, 17, 9], device=cuda),
            torch.tensor([0.45, 0.6, 0.72], device=cuda),
            torch.tensor([0.5, 0.41, 0.66], device=cuda), 10, NET["dt"])
    kw = dict(mother=M6, nfft=8192, dj=NET["dj"], batch=4, nchunks=3, n=n, tau=64)
    profiling.WCT_HEAD_KERNEL_POINTS = profiling.WCT_HEAD_PLAIN_POINTS = 0
    launches = wct_head.LAUNCHES["wct_fields_head"]
    kernel = tco._mc_histogram_run_pairs(*args, **kw)
    assert wct_head.LAUNCHES["wct_fields_head"] == launches + 3
    assert profiling.WCT_HEAD_KERNEL_POINTS == 3 * 3 * 4 * 110 * n
    _torch_head_only(monkeypatch)
    plain = tco._mc_histogram_run_pairs(*args, **kw)
    assert profiling.WCT_HEAD_PLAIN_POINTS == 3 * 3 * 4 * 110 * n
    assert torch.equal(kernel, plain)


@pytest.mark.parametrize("B, n0, nfft", [(3, 100, 128), (3, 147, 256), (2, 4000, 4096)])
def test_the_planar_wct_core_is_the_torch_heads(cuda, monkeypatch, B, n0, nfft):
    g = torch.Generator().manual_seed(n0)
    y1 = torch.randn((B, n0), generator=g).to(cuda)
    y2 = torch.randn((B, n0), generator=g).to(cuda)
    sj = (0.5 * 2.0 ** (torch.arange(76) / 12)).to(device=cuda, dtype=torch.float32)
    kw = dict(mother=M6, nfft=nfft, dj=1 / 12, engine="planar")
    launches = wct_head.LAUNCHES["wct_fields_head"]
    kernel = tco._wct_core(y1, y2, sj, 0.25, **kw)
    assert wct_head.LAUNCHES["wct_fields_head"] == launches + 1
    _torch_head_only(monkeypatch)
    plain = tco._wct_core(y1, y2, sj, 0.25, **kw)
    for a, b in zip((kernel[0], kernel[1], *kernel[2]), (plain[0], plain[1], *plain[2])):
        assert _same(a, b)


def test_wct_on_a_short_pair_is_the_torch_heads(cuda, monkeypatch):
    """``wct`` with its 40-member null on a pair of 100 samples (nfft 128,
    where the planar route's plain transform gives complex views) through
    the kernel and the torch head: the maps and the curve bit for bit."""
    g = torch.Generator().manual_seed(100)
    y1 = torch.randn(100, generator=g, dtype=torch.float64).numpy()
    y2 = (0.5 * y1 + torch.randn(100, generator=g, dtype=torch.float64).numpy())
    kw = dict(mc_count=40, cache=False, progress=False, seed=11, device=cuda)
    launches = wct_head.LAUNCHES["wct_fields_head"]
    kernel = pt.wct(y1, y2, 0.25, **kw)
    assert wct_head.LAUNCHES["wct_fields_head"] >= launches + 2   # the pair and a chunk
    _torch_head_only(monkeypatch)
    plain = pt.wct(y1, y2, 0.25, **kw)
    for k in (0, 1, 4):
        a, b = (torch.as_tensor(np.asarray(r[k])) for r in (kernel, plain))
        assert _same(a, b)


def test_wct_overlap_planar_is_the_torch_heads(cuda, monkeypatch):
    """The overlap-save coherence at 2^20 (4 chunks of 2^18 at nfft 2^19,
    the cell ``overlap_16m``'s grid) through the kernel and the torch head:
    the maps bit for bit."""
    g = torch.Generator().manual_seed(2 ** 20)
    y1 = torch.randn(1 << 20, generator=g, dtype=torch.float64)
    y2 = 0.5 * y1 + torch.randn(1 << 20, generator=g, dtype=torch.float64)
    dt, dj = 1 / 4096, 1 / 8
    sj = 2 * dt * 2.0 ** (dj * torch.arange(64, dtype=torch.float64))
    kw = dict(mother=M6, dj=dj, device=cuda)
    launches = wct_head.LAUNCHES["wct_fields_head"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the near-Nyquist caveat of s < 4 dt
        kernel = tov.wct_overlap_planar(y1, y2, sj, dt, **kw)
        assert wct_head.LAUNCHES["wct_fields_head"] == launches + 4
        _torch_head_only(monkeypatch)
        plain = tov.wct_overlap_planar(y1, y2, sj, dt, **kw)
    for a, b in zip(kernel, plain):
        assert a.shape == (64, 1 << 20) and _same(a, b)


@pytest.mark.parametrize("fault, error", [
    ("f64 planes", TypeError), ("planes on the CPU", ValueError),
    ("scales on the CPU", ValueError), ("leading dims that do not merge", ValueError),
    ("planes of two layouts", ValueError)])
def test_the_wrapper_refuses_on_the_card(cuda, fault, error):
    w1, w2 = _planes((2,), 4, 20, 32, seed=1, dev=cuda)
    planes, sc = [*w1, *w2], _scales(4, cuda)
    if fault == "f64 planes":
        planes = [p.double() for p in planes]
    elif fault == "planes on the CPU":
        planes[0] = planes[0].cpu()
    elif fault == "scales on the CPU":
        sc = sc.cpu()
    elif fault == "leading dims that do not merge":
        planes = [torch.randn((3, 2, 4, 32), device=cuda).transpose(0, 1)[..., :20]
                  for _ in range(4)]
    else:
        planes[1] = planes[1].contiguous()
    launches = wct_head.LAUNCHES["wct_fields_head"]
    with pytest.raises(error):
        wct_head.fields_head(*planes, sc)
    assert wct_head.LAUNCHES["wct_fields_head"] == launches
