"""The end-to-end arithmetic and the trace reduction on made-up timelines."""

import math

import pytest
import torch

from port_bench import run
from port_bench.common import stats, trace


def test_whole_window_rate_spans_first_start_to_last_end():
    # Three batches of 480 audio-s with a gap between the 2nd and 3rd: the
    # gap counts against the rate.
    spans = [(10.0, 20.0), (20.0, 30.0), (35.0, 45.0)]
    assert stats.whole_window_rate([480, 480, 480], spans) == pytest.approx(1440 / 35.0)
    with pytest.raises(ValueError):
        stats.whole_window_rate([], [])


def test_percentile_over_all_requests_failures_infinite():
    lat = [float(i) for i in range(1, 101)]
    assert stats.percentile(lat, 50) == 50.0
    assert stats.percentile(lat, 95) == 95.0
    # Six failed requests among 100: the 95th percentile reaches them.
    lat_f = lat[:94] + [math.inf] * 6
    assert stats.percentile(lat_f, 95) == math.inf
    assert stats.percentile(lat_f, 50) == 50.0


def test_serve_arrivals_fill_the_window_alike_for_every_seed():
    # The open loop offers every seed the same arrivals; the seed draws
    # only what arrives (weights, utterances).
    drv = run.load_module(run.BENCH / "drivers" / "open_loop.py")
    due = drv.arrivals(5.5, 51.0)
    assert len(due) == 280 and due[0] == 0.0 and 50.0 < due[-1] < 51.0
    assert (due[1:] > due[:-1]).all()
    assert (drv.arrivals(5.5, 51.0) == due).all()
    gaps = due[1:] - due[:-1]
    assert gaps.max() > 5 * sorted(gaps)[len(gaps) // 2]  # exponential quantiles, not even spacing
    assert not (gaps[1:] >= gaps[:-1]).all() and not (gaps[1:] <= gaps[:-1]).all()  # shuffled


def test_merged_intervals_of_streams():
    busy = [(1.0, 4.0), (2.0, 6.0), (12.0, 13.0)]  # two streams overlap on [2, 4)
    assert stats.merged(busy) == [(1.0, 6.0), (12.0, 13.0)]


class _Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._du = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._du


def test_trace_reduce_busy_kernels_and_gaps():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = [
        _Ev("flash_fwd_bf16", cuda, 100, 200),      # [100, 300)
        _Ev("gemm", cuda, 250, 150),                # [250, 400): overlaps on another stream
        _Ev("Memcpy HtoD", cuda, 600, 100),         # [600, 700)
        _Ev("aten::outer", cpu, 0, 1000),
        _Ev("aten::item", cpu, 420, 160),           # innermost at the gap [400, 600)
    ]
    r = trace.reduce(ev, 0, 1000)
    assert r["kernels"] == 2 and r["busy_s"] == pytest.approx(400e-9)
    assert r["wall_s"] == pytest.approx(1000e-9)
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(200e-9)
    assert gaps["aten::outer"] == pytest.approx(400e-9)  # [0, 100) and [700, 1000)
    assert trace.kernel_seconds(r, ("flash_fwd",)) == (1, pytest.approx(200e-9))
    assert r["device_ops"][0][0] == "flash_fwd_bf16"
    # The idle share is one minus the union of the streams' activity.
    idle = run.load_module(run.BENCH / "metrics" / "device_idle.offline.py")
    assert idle.read({"slice": r}) == pytest.approx(60.0)


def test_trace_reduce_without_host_events():
    cuda = torch.autograd.DeviceType.CUDA
    r = trace.reduce([_Ev("k", cuda, 10, 10)], 0, 100)
    assert r["idle_gaps"] == [["host not traced", pytest.approx(90e-9)]]
