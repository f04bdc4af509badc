"""cwt_roofline_pct counts the call's own work: the signal read once, the
output written once and the FFTs' operations, pinned here to the figures
worked by hand for the two CWT cells."""
import pytest

from cwtbench import harness, kernel_bounds, peaks

ROOF = harness.load_module("metrics", "cwt_roofline_pct")

GWS = {"kind": "cwt", "B": 1, "n0": 2 ** 20, "nfft": 2 ** 20, "S": 64,
       "output": "power_sum", "kernel_output": "power_sum"}
W4M = {"kind": "cwt", "B": 1, "n0": 2 ** 22, "nfft": 2 ** 22, "S": 64,
       "output": "W", "kernel_output": "planes"}


def test_power_sum_at_2_20():
    # 4 * 2^20 bytes in, 64 f32 sums out
    assert ROOF.call_bytes(GWS) == 4_194_304 + 256
    # 2.5 N 20 + 64 (6 N + 5 N 20 + 3 N) = (50 + 64 * 109) N
    assert ROOF.call_ops(GWS) == 7_367_294_976
    assert ROOF.bound_s(GWS) == pytest.approx(7_367_294_976 / 67e12)
    assert ROOF.bound_s(GWS) == pytest.approx(1.0996e-4, rel=1e-4)   # operations-bound


def test_w_planes_at_2_22():
    # 4 * 2^22 in, 64 * 2^22 complex64 out
    assert ROOF.call_bytes(W4M) == 16_777_216 + 2_147_483_648
    # 2.5 N 22 + 64 (6 N + 5 N 22) = (55 + 64 * 116) N
    assert ROOF.call_ops(W4M) == 31_369_199_616
    assert ROOF.bound_s(W4M) == pytest.approx(2_164_260_864 / 3.35e12)
    assert ROOF.bound_s(W4M) == pytest.approx(6.4605e-4, rel=1e-4)   # bytes-bound


class _Trace:
    def __init__(self, shape, per_call_s):
        self.entry = type("E", (), {"shape": shape})()
        self._t = per_call_s

    def per_call_s(self, match=None):
        return self._t


def test_share_from_device_time():
    assert ROOF.read(_Trace(GWS, 0.702e-3)) == pytest.approx(
        100 * 7_367_294_976 / 67e12 / 0.702e-3)
    assert ROOF.read(_Trace(GWS, None)) is None
    assert ROOF.read(_Trace({"kind": "wct"}, 1e-3)) is None


def test_kernel_bounds_count_t():
    b = kernel_bounds.k1_k2(GWS, 2 ** 19)
    # K2 at 2^20 x 64: T's two f32 planes read, 64 sums written
    assert b["cwt_stage_b"] == pytest.approx((2 * 64 * 2 ** 20 * 4 + 256) / peaks.HBM_BYTES_S)
    assert b["cwt_stage_a"] == pytest.approx(
        (2 * 2 ** 19 * 4 + 256 + 2 * 64 * 2 ** 20 * 4) / peaks.HBM_BYTES_S)
