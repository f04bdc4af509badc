"""The coherence head on the CPU (``coherence._planar_fields``,
``ops/wct_head.py``, ``csrc/wct_head.cu``): the route (the CPU, f64 and
planes that ask for a gradient take the torch head and count its points,
even where the card's seam says yes); the wrapper through a stand-in for
the CUDA library, which computes what the kernel computes, in float32 numpy
with each op rounded on its own, from the pointers, strides and shape it
is given, against the torch head, bit for bit, at trimmed, whole, odd,
single-scale, complex-view, transposed and overlapping layouts, and on the
planar route below nfft 2^8, whose plain transform gives complex views;
the wrapper's refusals; the Monte-Carlo chunk asking
for no cross planes; the planar ``_wct_core``'s gradient; the counters.
The kernel itself runs on the card in ``test_torch_wct_head_cuda.py``."""
import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

import pycwt_torch as pt
from pycwt_torch import coherence as tco
from pycwt_torch import stats as tst
from pycwt_torch.config import CWTConfig
from pycwt_torch.ops import wct_head
from pycwt_torch.ops.smoothing import smooth
from pycwt_torch.utils import profiling

torch.set_num_threads(2)

M6 = pt.Morlet(6)
#: a small Monte-Carlo grid (tests/test_torch_mc.py's SMALL): 8 scales
GRID = dict(dt=1.0, dj=1 / 4, s0=2.0, J=7)
KW = dict(dt=GRID["dt"], dj=GRID["dj"], mother=M6)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the span recorder off and the
    counters at 0."""
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()
    yield
    profiling.disable_spans()
    profiling.enable_spans()
    profiling.disable_spans()


def _grid():
    n, sj, oc, _, _ = tco._surrogate_grid(GRID["dt"], GRID["dj"], GRID["s0"],
                                          GRID["J"], M6)
    return n, torch.tensor(sj, dtype=torch.float32), torch.tensor(oc)


def _planes(lead, S, n, pitch=None, seed=0, dtype=torch.float32):
    """Four random planes ``(*lead, S, n)``, the trimmed views of width-
    ``pitch`` rows where a pitch is given, with zeros, a NaN, ±inf and
    subnormal values among them."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((4, *lead, S, pitch or n), generator=g, dtype=dtype)
    flat = full.view(4, -1)
    at = torch.randperm(flat.shape[1], generator=g)[:8].tolist()
    for k, (i, v) in enumerate(zip(at, [0.0, -0.0, float("nan"), float("inf"),
                                        -float("inf"), 1e-39, -3e-42, 2e-20])):
        flat[k % 4, i] = v
    full = full[..., :n]
    return (full[0], full[1]), (full[2], full[3])


def _scales(S, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(S, generator=g) * 40 + 0.5


def _old_head(w1, w2, scales):
    """The head of ``_planar_fields`` as it was before the kernel."""
    (w1r, w1i), (w2r, w2i) = w1, w2
    s_col = scales[:, None]
    w12r, w12i = tco._cross(w1, w2)
    return (torch.complex((w1r ** 2 + w1i ** 2) / s_col, (w2r ** 2 + w2i ** 2) / s_col),
            torch.complex(w12r / s_col, w12i / s_col), (w12r, w12i))


def _old_planar_coherence(w1, w2, scales, *, dt, dj, mother):
    """``_planar_coherence`` before the head had a kernel."""
    (w1r, w1i), (w2r, w2i) = w1, w2
    s_col = scales[:, None]
    Sm = smooth(torch.complex((w1r ** 2 + w1i ** 2) / s_col,
                              (w2r ** 2 + w2i ** 2) / s_col), dt, dj, scales, mother)
    w12r, w12i = tco._cross(w1, w2)
    Cm = smooth(torch.complex(w12r / s_col, w12i / s_col), dt, dj, scales, mother)
    return tco._coherence_ratio(Sm, Cm), torch.atan2(w12i, w12r), (w12r, w12i)


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


# --------------------------------------------------------------------------
# The route
# --------------------------------------------------------------------------

def test_the_torch_head_is_the_old_head_bit_for_bit():
    w1, w2 = _planes((3,), 5, 37, pitch=64)
    sc = _scales(5)
    new = tco._torch_head(w1, w2, sc)
    old = _old_head(w1, w2, sc)
    for a, b in zip((new[0], new[1], *new[2]), (old[0], old[1], *old[2])):
        assert _same(a, b)
    assert tco._torch_head(w1, w2, sc, cross=False)[2] is None


def test_cpu_planes_take_the_torch_head_and_count_its_points(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CPU planes reached the kernel's wrapper")

    monkeypatch.setattr(wct_head, "fields_head", refuse)
    w1, w2 = _planes((2,), 6, 50, pitch=64)
    tco._planar_fields(w1, w2, _scales(6), **KW)
    assert profiling.WCT_HEAD_PLAIN_POINTS == 2 * 6 * 50
    assert profiling.WCT_HEAD_KERNEL_POINTS == 0


@pytest.fixture
def card_seam(monkeypatch):
    """The seam says every plane lies on the card; the wrapper records the
    calls it gets instead of launching."""
    calls = []

    def record(*planes, cross=False):
        calls.append(cross)
        return tco._torch_head(planes[:2], planes[2:4], planes[4], cross=cross)

    monkeypatch.setattr(wct_head, "on_card", lambda plane: True)
    monkeypatch.setattr(wct_head, "fields_head", record)
    return calls


@pytest.mark.parametrize("case", ["f64 planes", "f64 scales", "planes need a gradient",
                                  "scales need a gradient"])
def test_what_the_kernel_does_not_take_goes_the_torch_way(card_seam, case):
    dtype = torch.float64 if case == "f64 planes" else torch.float32
    w1, w2 = _planes((2,), 4, 30, dtype=dtype)
    sc = _scales(4).to(torch.float64 if case == "f64 scales" else torch.float32)
    if case == "planes need a gradient":
        w1 = (w1[0].clone().requires_grad_(), w1[1])
    if case == "scales need a gradient":
        sc = sc.clone().requires_grad_()
    tco._planar_fields(w1, w2, sc, **KW)
    assert card_seam == [] and profiling.WCT_HEAD_PLAIN_POINTS == 2 * 4 * 30


def test_f32_planes_on_the_card_take_the_kernel(card_seam):
    w1, w2 = _planes((2,), 4, 30)
    tco._planar_fields(w1, w2, _scales(4), **KW)
    w1g = (w1[0].clone().requires_grad_(), w1[1])
    with torch.no_grad():          # no gradient asked: the kernel
        tco._planar_fields(w1g, w2, _scales(4), **KW, cross=False)
    assert card_seam == [True, False]


def test_the_mc_chunk_asks_for_no_cross_planes(card_seam):
    """``_mc_histogram_chunk`` and ``_mc_histogram_run_pairs`` on the planar
    route: each chunk's head is one kernel call without the cross planes;
    the pair's own coherence keeps them."""
    n, sj, oc = _grid()
    kw = dict(mother=M6, nfft=tco.DEFAULT.fft_length(n), dj=GRID["dj"], engine="planar")
    tco._mc_histogram_chunk(tst.PRNGKey(3), 0, sj, oc, 1.0, batch=4, al1=0.4, al2=0.6,
                            n=n, **kw)
    tco._mc_histogram_run_pairs(tst.PRNGKey(4), sj, oc, torch.tensor([1, 2]),
                                torch.tensor([0.3, 0.5]), torch.tensor([0.2, 0.6]), 5, 1.0,
                                batch=3, nchunks=2, n=n, tau=8, **kw)
    assert card_seam == [False, False, False]
    x = torch.randn(2, n)
    tco._wct_core(x, x.flip(-1), sj, 1.0, mother=M6, nfft=kw["nfft"], dj=GRID["dj"],
                  engine="planar")
    assert card_seam[-1] is True


def test_the_planar_coherence_gradient_is_unchanged(monkeypatch):
    """Planes that ask for a gradient take the torch head even where the
    card's seam says yes, and the gradient of the coherence is the old
    one's, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("planes that ask for a gradient reached the kernel")

    monkeypatch.setattr(wct_head, "on_card", lambda plane: True)
    monkeypatch.setattr(wct_head, "fields_head", refuse)
    n, sj, _ = _grid()
    w1, w2 = _planes((2,), sj.shape[0], n, seed=7)
    grads = []
    for fn in (tco._planar_coherence, _old_planar_coherence):
        leaves = [t.detach().clone().requires_grad_() for t in (*w1, *w2)]
        R, A, (xr, xi) = fn((leaves[0], leaves[1]), (leaves[2], leaves[3]), sj, **KW)
        loss = torch.nan_to_num(R).sum() + torch.nan_to_num(A).sum() + xr.sum() + xi.sum()
        loss.backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert _same(a, b)


# --------------------------------------------------------------------------
# The wrapper, through a stand-in for the library
# --------------------------------------------------------------------------

def _array(ptr, count, ctype):
    return np.ctypeslib.as_array((ctype * count).from_address(ptr))


def _head_mirror(a, b, c, d, s):
    """``head_of`` of ``csrc/wct_head.cu`` in float32 numpy, each op rounded
    on its own: the fields' four parts and the cross planes."""
    with np.errstate(all="ignore"):
        xr = a * c + b * d
        xi = b * c - a * d
        return (a * a + b * b) / s, (c * c + d * d) / s, xr / s, xi / s, xr, xi


class StandIn:
    """The CUDA library ``wct_head`` for CPU tensors: ``wct_fields_head``
    reads the planes at the strides and the scales through the pointers
    the wrapper passes and writes :func:`_head_mirror`'s fields (and cross
    planes) into the outputs.  It stands in for ``torch.cuda.device`` and
    ``torch.cuda.current_stream`` too, and asserts that it runs inside the
    guard of the planes' device, on that device's stream."""

    def __init__(self):
        self.calls = []
        self.guards = []
        self.streams = []

    @contextlib.contextmanager
    def device(self, dev):
        self.guards.append(dev)
        try:
            yield
        finally:
            self.guards.pop()

    def current_stream(self, device=None):
        self.streams.append(device)
        return types.SimpleNamespace(cuda_stream=0)

    def wct_fields_head(self, w1r, w1i, w2r, w2i, scales, s, c, xr, xi, R, S, n, sr, ss, st,
                        stream):
        assert self.guards == [torch.device("cpu")] and self.streams[-1] == torch.device("cpu")
        self.calls.append((R, S, n, (sr, ss, st), xr is not None))
        rows = R * S
        idx = ((np.arange(R)[:, None, None] * sr + np.arange(S)[None, :, None] * ss
                + np.arange(n)[None, None, :] * st).reshape(rows, n))
        span = int(idx.max()) + 1
        a, b, cc, d = (_array(p, span, ctypes.c_float)[idx] for p in (w1r, w1i, w2r, w2i))
        sc = np.tile(_array(scales, S, ctypes.c_float), R)[:, None]
        s1, s2, cr, ci, x_r, x_i = _head_mirror(a, b, cc, d, sc)
        out_s = _array(s, 2 * rows * n, ctypes.c_float).reshape(rows, n, 2)
        out_c = _array(c, 2 * rows * n, ctypes.c_float).reshape(rows, n, 2)
        out_s[..., 0], out_s[..., 1], out_c[..., 0], out_c[..., 1] = s1, s2, cr, ci
        if xr is not None:
            _array(xr, rows * n, ctypes.c_float)[:] = x_r.reshape(-1)
            _array(xi, rows * n, ctypes.c_float)[:] = x_i.reshape(-1)
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """CPU planes take the kernel's wrapper, which calls the stand-in
    library on the CPU tensors' memory."""
    lib = StandIn()
    monkeypatch.setattr(wct_head, "on_card", lambda plane: True)
    monkeypatch.setattr(wct_head, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device", lib.device)
    monkeypatch.setattr(torch.cuda, "current_stream", lib.current_stream)
    return lib


def _complex_views(lead, S, n, nfft, seed):
    """The real and imaginary views of two complex W ``(*lead, S, nfft)``
    trimmed to ``n``, as the planar route's plain transform gives them below
    nfft 2^8: points two floats apart."""
    g = torch.Generator().manual_seed(seed)
    W = torch.randn((2, *lead, S, nfft), generator=g, dtype=torch.complex64)[..., :n]
    return (W[0].real, W[0].imag), (W[1].real, W[1].imag)


def _transposed(lead, S, n, seed):
    """Planes ``(*lead, S, n)`` whose scales are consecutive in memory."""
    g = torch.Generator().manual_seed(seed)
    full = torch.randn((4, *lead, n, S), generator=g).transpose(-1, -2)
    return (full[0], full[1]), (full[2], full[3])


def _overlapping(seed):
    """Planes ``(2, 4, 20)`` whose rows overlap: each row starts 10 floats
    after the last."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randn((4, 200), generator=g)
    planes = [flat[k].as_strided((2, 4, 20), (40, 10, 1)) for k in range(4)]
    return (planes[0], planes[1]), (planes[2], planes[3])


#: (lead, S, n, the planes' maker, the strides the kernel is given)
LAYOUTS = {
    "mc-trimmed": ((2, 9), 11, 63, lambda: _planes((2, 9), 11, 63, pitch=128, seed=63),
                   (11 * 128, 128, 1)),
    "overlap-whole": ((), 8, 256, lambda: _planes((), 8, 256, seed=256), (0, 256, 1)),
    "odd-one-scale": ((3,), 1, 85, lambda: _planes((3,), 1, 85, pitch=128, seed=85),
                      (128, 0, 1)),
    "contiguous-one-scale": ((5,), 1, 17, lambda: _planes((5,), 1, 17, seed=17), (17, 0, 1)),
    "complex-views": ((3,), 5, 37, lambda: _complex_views((3,), 5, 37, 64, seed=37),
                      (5 * 128, 128, 2)),
    "transposed": ((2,), 4, 20, lambda: _transposed((2,), 4, 20, seed=20), (80, 1, 4)),
    "overlapping-rows": ((2,), 4, 20, lambda: _overlapping(seed=40), (40, 10, 1)),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("cross", [True, False], ids=["cross", "fields"])
def test_the_wrapper_writes_the_torch_heads_fields(stand_in, layout, cross):
    lead, S, n, make, strides = LAYOUTS[layout]
    w1, w2 = make()
    sc = _scales(S)
    launches = wct_head.LAUNCHES["wct_fields_head"]
    got = wct_head.fields_head(*w1, *w2, sc, cross=cross)
    want = tco._torch_head(w1, w2, sc, cross=cross)
    R = int(np.prod(lead))
    assert stand_in.calls == [(R, S, n, strides, cross)]
    assert wct_head.LAUNCHES["wct_fields_head"] == launches + 1
    assert profiling.WCT_HEAD_KERNEL_POINTS == R * S * n
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == torch.complex64 and a.is_contiguous() and _same(a, b)
    if cross:
        for a, b in zip(got[2], want[2]):
            assert a.dtype == torch.float32 and a.is_contiguous() and _same(a, b)
    else:
        assert got[2] is None


@pytest.mark.parametrize("n0", [1, 60, 100])
def test_the_planar_route_below_2_8_takes_the_kernel(stand_in, monkeypatch, n0):
    """Below nfft 2^8 the planar route's plain transform gives the real and
    imaginary views of a complex W; the kernel's wrapper takes them as they
    are, and the WCT, phase and W12 are the torch head's, bit for bit."""
    g = torch.Generator().manual_seed(n0)
    y1, y2 = torch.randn((2, 3, n0), generator=g)
    sj = (0.5 * 2.0 ** (torch.arange(20) / 4)).to(torch.float32)
    kw = dict(mother=M6, nfft=128, dj=0.25, engine="planar")
    kernel = tco._wct_core(y1, y2, sj, 1.0, **kw)
    assert stand_in.calls == [(3, 20, n0, (20 * 256, 256, 2 if n0 > 1 else 0), True)]
    monkeypatch.setattr(tco, "_head_on_card", lambda w1, w2, scales: False)
    plain = tco._wct_core(y1, y2, sj, 1.0, **kw)
    for a, b in zip((kernel[0], kernel[1], *kernel[2]), (plain[0], plain[1], *plain[2])):
        assert _same(a, b)


def test_wct_on_a_short_pair_through_the_wrapper(stand_in, monkeypatch):
    """``wct`` on the planar route with its 20-member null on a pair of 100
    samples: the pair's head and each chunk's go through the wrapper, and
    the maps and the curve are the torch head's, bit for bit."""
    g = torch.Generator().manual_seed(100)
    y1 = torch.randn(100, generator=g, dtype=torch.float64).numpy()
    y2 = 0.5 * y1 + torch.randn(100, generator=g, dtype=torch.float64).numpy()
    kw = dict(mc_count=20, cache=False, progress=False, seed=11, device="cpu",
              config=CWTConfig(engine="planar"))
    kernel = pt.wct(y1, y2, 0.25, **kw)
    assert len(stand_in.calls) >= 2 and stand_in.calls[0][3][2] == 2
    assert [c[4] for c in stand_in.calls] == [True] + [False] * (len(stand_in.calls) - 1)
    monkeypatch.setattr(tco, "_head_on_card", lambda w1, w2, scales: False)
    plain = pt.wct(y1, y2, 0.25, **kw)
    for k in (0, 1, 4):
        assert _same(*(torch.as_tensor(np.asarray(r[k])) for r in (kernel, plain)))


def test_the_fields_through_the_wrapper_smooth_as_the_torch_heads(stand_in, monkeypatch):
    """``_planar_coherence`` through the wrapper gives the old ``(WCT,
    phase, W12)`` bit for bit."""
    n, sj, _ = _grid()
    w1, w2 = _planes((3,), sj.shape[0], n, pitch=64, seed=5)
    new = tco._planar_coherence(w1, w2, sj, **KW)
    old = _old_planar_coherence(w1, w2, sj, **KW)
    assert len(stand_in.calls) == 1
    for a, b in zip((new[0], new[1], *new[2]), (old[0], old[1], *old[2])):
        assert _same(a, b)


@pytest.mark.parametrize("fault, error, match", [
    ("f64 plane", TypeError, "float32"),
    ("f64 scales", TypeError, "float32"),
    ("1-D planes", ValueError, "one shape"),
    ("planes of two shapes", ValueError, "one shape"),
    ("scales of another length", ValueError, "the scales are"),
    ("strided scales", ValueError, "the scales are"),
    ("leading dims that do not merge", ValueError, "one layout"),
    ("planes of two layouts", ValueError, "one layout"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(stand_in, fault, error, match):
    w1, w2 = _planes((2,), 4, 20, pitch=32)
    planes = [*w1, *w2]
    sc = _scales(4)
    if fault == "f64 plane":
        planes[2] = planes[2].double()
    elif fault == "f64 scales":
        sc = sc.double()
    elif fault == "1-D planes":
        planes = [p[0, 0] for p in planes]
    elif fault == "planes of two shapes":
        planes[1] = planes[1][:, :3]
    elif fault == "scales of another length":
        sc = _scales(5)
    elif fault == "strided scales":
        sc = _scales(8)[::2]
    elif fault == "leading dims that do not merge":
        planes = [torch.randn(3, 2, 4, 32).transpose(0, 1)[..., :20] for _ in range(4)]
    else:
        planes[3] = planes[3].contiguous()
    with pytest.raises(error, match=match):
        wct_head.fields_head(*planes, sc)
    assert stand_in.calls == []


def test_the_wrapper_refuses_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU planes loaded {name}")

    monkeypatch.setattr(wct_head, "library", refuse)
    w1, w2 = _planes((2,), 4, 20)
    with pytest.raises(ValueError, match="one CUDA device"):
        wct_head.fields_head(*w1, *w2, _scales(4))


def test_no_point_no_launch(stand_in):
    w1, w2 = _planes((0,), 4, 20)
    S, C, w12 = wct_head.fields_head(*w1, *w2, _scales(4), cross=True)
    assert S.shape == C.shape == w12[0].shape == (0, 4, 20)
    assert stand_in.calls == [] and profiling.WCT_HEAD_KERNEL_POINTS == 0


# --------------------------------------------------------------------------
# The counters
# --------------------------------------------------------------------------

def test_enable_spans_clears_the_head_counters():
    profiling.WCT_HEAD_KERNEL_POINTS, profiling.WCT_HEAD_PLAIN_POINTS = 5, 2
    profiling.enable_spans()
    assert profiling.WCT_HEAD_KERNEL_POINTS == profiling.WCT_HEAD_PLAIN_POINTS == 0
