"""The metric arithmetic on hand-made readings: the tail of due-time
latencies with a stall, the device's busy union and idle gaps, the kernels'
bounds and their roofline share."""

import types

import numpy as np
import pytest
import torch

import costs
import harness
import tracing
from conftest import BENCH


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_p95_counts_a_stall_against_every_later_scan():
    # 200 scans due every 100 ms, each done 60 ms after it is due, and one
    # stall of 500 ms at scan 100 that the next scans wait out.
    due = np.arange(200) * 100.0
    done, t = [], 0.0
    for k, d in enumerate(due):
        start = max(d, t)
        t = start + (560.0 if k == 100 else 60.0)
        done.append(t)
    lat = list(np.array(done) - due)
    got = reader("scan_latency_p95_ms").read({"mode": "online", "latencies_ms": lat})
    assert got == pytest.approx(np.percentile(lat, 95))
    assert sorted(lat)[-6:] == [60.0 + 460.0 - 40.0 * i for i in range(5, -1, -1)][::-1] or max(lat) == 560.0
    assert got > 60.0  # the stall and the queue behind it are the tail
    assert reader("scan_latency_p95_ms").read({"mode": "replay", "latencies_ms": lat}) is None


def test_rate_setup_and_attempts():
    assert reader("scans_per_s").read({"mode": "replay", "polled_in_window": 450, "window_s": 30.0}) == 15.0
    assert reader("setup_s").read({"setup_s": 31.5}) == 31.5


class _Ev:
    def __init__(self, name, a, b, dev):
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        from torch.autograd import DeviceType

        self.device_type = DeviceType.CUDA if dev else DeviceType.CPU


class _Prof:
    def __init__(self, events):
        self._e = events

    def events(self):
        return self._e


def test_busy_union_idle_gaps_and_kernel_time():
    ev = [
        _Ev(tracing.WINDOW, 0, 1000, False),
        _Ev("bench.dispatch", 0, 400, False),
        _Ev("cudaStreamSynchronize", 300, 400, False),
        _Ev("void pair_gn_fused<4>(float*)", 100, 200, True),
        _Ev("ampere_sgemm", 150, 300, True),  # overlaps: counted once
        _Ev("void sym_eig_kernel<12, double>(x)", 500, 600, True),
        _Ev("late", 990, 1200, True),  # clipped to the window
    ]
    got = tracing.read(_Prof(ev))
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx((200 + 100 + 10) / 1e6)
    assert got["kernel_device_s"] == {"pair_gn": pytest.approx(1e-4), "sym_eig": pytest.approx(1e-4)}
    gaps = dict((round(v * 1e6), k) for k, v in got["idle_gaps"])
    assert set(gaps) == {100, 200, 390}
    assert gaps[100] == "bench.dispatch/bench.dispatch" or gaps[100].startswith("bench.dispatch")
    idle = reader("idle_share.replay").read({"mode": "replay", "trace": got})
    assert idle == pytest.approx(100 * (1 - 310 / 1000))


def test_kernel_bounds_and_roofline_share():
    r = torch.zeros(1, 16384, 3)
    # K1 at the step's fine shape: bytes bound (0.61 MB, chip_smoke's figure).
    b = costs.pair_gn(r, torch.zeros(1, 16384, 3))
    assert b == pytest.approx((16384 * 12 + 16384 * 25 + 68 + 124) / costs.PEAK_BYTES_PER_S)
    A = torch.zeros(8, 12, 12, dtype=torch.float64)
    flops = 8 * 12 * 11 // 2 * (18 * 12 + 15)
    assert costs.sym_eig(A) == pytest.approx(max(8 * (2 * 144 + 12) * 8 / costs.PEAK_BYTES_PER_S,
                                                 flops / costs.PEAK_FP64_FLOP_PER_S))
    assert costs.kernel_family("void normal_eq_partial<8, 1>(float const*)") == "normal_eq"
    assert costs.kernel_family("void (anonymous namespace)::pair_gn_fused<4>(float const*, int)") == "pair_gn"
    assert costs.kernel_family("void at::native::vectorized_elementwise_kernel<4>") is None
    share = reader("kernels_roofline.replay").read(
        {"mode": "replay", "trace": {"kernel_device_s": {"pair_gn": 4e-6, "normal_eq": 6e-6}, "kernel_bound_s": 1e-6}})
    assert share == pytest.approx(10.0)
    assert reader("kernels_roofline.replay").read(
        {"mode": "replay", "trace": {"kernel_device_s": {}, "kernel_bound_s": 0.0}}) is None
