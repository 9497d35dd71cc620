"""The readers of the program's spans (spans.py and the five metrics that
use it) on synthetic slices, spans and profile events: the arithmetic, and
nothing read where the program keeps no spans."""
from __future__ import annotations

import sys
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import run as runmod
from portbench import spans

S = 1_700_000_000.0            # a slice's start, seconds on the Unix clock


def _span(name, a, b, thread=1, sid=0, parent=None):
    return types.SimpleNamespace(name=name, start_ns=int(round(a * 1e9)),
                                 end_ns=int(round(b * 1e9)), thread=thread, id=sid,
                                 parent=parent)


def _slice(device, lo, hi, functions=()):
    return types.SimpleNamespace(device=[(a, b, "k") for a, b in device], lo=lo, hi=hi,
                                 window_s=hi - lo, functions=list(functions))


def _ctx(kind, slice_):
    return types.SimpleNamespace(kind=kind, slice=slice_, facts={}, config={})


@pytest.fixture
def ring(monkeypatch):
    """The program's ring, emptied for the test; ``add`` records spans in it."""
    from facevae_tpu_torch import tracing
    r = tracing.Ring(1 << 10)
    monkeypatch.setattr(tracing, "RING", r)

    def add(name, a, b, **kw):
        tracing.record(name, int(round(a * 1e9)), int(round(b * 1e9)), **kw)
    return add


def test_durations_lie_in_or_end_in_the_slice():
    got = [_span("x", S - 1, S + 1), _span("x", S + 1, S + 1.004), _span("x", S + 9, S + 11),
           _span("y", S + 2, S + 3)]
    assert spans.durations_ms(got, "x", S, S + 10) == pytest.approx([4.0])
    assert spans.durations_ms(got, "x", S, S + 10, ends_in=True) == pytest.approx([2000, 4])
    assert spans.median_ms(None, "x", S, S + 10) is None
    assert spans.median_ms(got, "z", S, S + 10) is None


@pytest.mark.parametrize("a,b,want", [
    ([(0, 2), (1, 3)], [(2.5, 10)], 0.5),
    ([(0, 10)], [(1, 2), (3, 4)], 2.0),
    ([(0, 1)], [(1, 2)], 0.0),
    ([], [(0, 1)], 0.0),
])
def test_overlap_of_two_unions(a, b, want):
    assert spans.overlap(a, b) == pytest.approx(want)


def test_idle_within_flushes_and_between():
    # device busy [1,3] and [5,9]; flushes [0,4] and [4.5,10]; slice [1,9]
    device, flushes = [(1, 3), (5, 9)], [(0, 4), (4.5, 10)]
    assert spans.idle_within(device, flushes, 1, 9) == pytest.approx(1.0 + 0.5)
    assert spans.gaps(device, 1, 9) == [(3, 5)]
    assert spans.gaps(device, 0, 10) == [(0, 1), (3, 5), (9, 10)]


def test_idle_by_innermost_span_of_a_thread():
    device = [(0, 1), (1.2, 2.0), (2.6, 3), (5, 6)]
    got = [_span("flush", 0.5, 3.5, sid=1), _span("graph", 0.8, 1.8, sid=2, parent=1),
           _span("other", 0, 10, thread=2, sid=3), _span("queue", 2.0, 5.5, sid=4, parent=3)]
    assert spans.idle_by_innermost(device, 0, 6, got, thread=1) == \
        pytest.approx({"graph": 0.2, "flush": 0.6, "none": 2.0})


def _fe(name, parent=None, kernels=(), is_async=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CPU, is_async=is_async, cpu_parent=parent,
        kernels=[types.SimpleNamespace(name=k, device=0, duration=us) for k, us in kernels])


def _step_events():
    """A step: a forward op, a recompute range (nested in another) holding
    two ops, the range's own copy on the device lane, a legacy timing, and
    an async event."""
    fwd = _fe("aten::conv", kernels=[("k_fwd", 60.0)])
    outer = _fe("remat.recompute.mfe", kernels=[("remat.recompute.mfe", 30.0), ("k_direct", 2.0)])
    inner = _fe("remat.recompute.mfe", parent=outer)
    op_a = _fe("aten::conv", parent=inner, kernels=[("k_a", 25.0), ("aten::conv", 25.0)])
    op_b = _fe("aten::mm", parent=outer, kernels=[("k_b", 3.0)])
    lost = _fe("aten::add", kernels=[("k_c", 10.0)], is_async=True)
    return [fwd, outer, inner, op_a, op_b, lost]


def test_device_time_under_outermost_ranges():
    under, total = spans.device_us_under(_step_events(), "remat.recompute.")
    assert under == {"remat.recompute.mfe": 30.0} and total == 90.0
    assert spans.share_under(_step_events(), "remat.recompute.") == pytest.approx(100 / 3)
    assert spans.share_under(_step_events(), "net.") is None


def test_device_time_on_a_real_cpu_profile():
    """FunctionEvents of a real profile have what device_us_under reads (on
    the CPU there is no device time to charge)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("remat.recompute.x"):
            torch.ones(4).sum()
    assert spans.device_us_under(prof.events(), "remat.recompute.") == ({}, 0.0)


def test_remat_share_reader():
    ctx = _ctx("train", _slice([], 0, 0, _step_events()))
    assert runmod.read_metric("remat_share.train", ctx) == pytest.approx(100 / 3)
    assert runmod.read_metric("remat_share.train", _ctx("serve", ctx.slice)) is None
    assert runmod.read_metric("remat_share.train", _ctx("train", None)) is None


def test_serve_readers_on_the_ring(ring):
    lo, hi = S + 1, S + 3
    sl = _slice([(S + 1, S + 1.7), (S + 2.1, S + 2.8), (S + 2.9, S + 3)], lo, hi)
    ring("serve.flush", S + 0.5, S + 1.9)
    ring("serve.flush", S + 2.0, S + 3.5)
    ring("serve.queue", S + 0.2, S + 0.5)             # ends before the slice
    ring("serve.queue", S + 1.0, S + 2.0)             # 1000 ms
    ring("serve.queue", S + 1.95, S + 2.0)            # 50 ms
    ring("serve.queue", S + 1.9, S + 2.0)             # 100 ms
    ring("serve.assemble", S + 0.5, S + 0.51)         # before the slice
    ring("serve.assemble", S + 2.0, S + 2.004)
    ring("serve.assemble", S + 2.5, S + 2.508)
    ring("serve.graph", S + 2.01, S + 2.03)
    ring("serve.graph", S + 0.6, S + 1.1)             # starts before the slice
    ctx = _ctx("serve", sl)
    assert runmod.read_metric("queue_wait_ms.serve", ctx) == pytest.approx(100.0, abs=1e-3)
    assert runmod.read_metric("assemble_ms.serve", ctx) == pytest.approx(6.0, abs=1e-3)
    assert runmod.read_metric("graph_host_ms.serve", ctx) == pytest.approx(20.0, abs=1e-3)
    # idle in the slice [1,3]: (1.7,2.1) and (2.8,2.9) = 0.5 s; inside the
    # flushes [1,1.9] and [2,3]: (1.7,1.9), (2.0,2.1), (2.8,2.9) = 0.4 s
    idle_in = runmod.read_metric("idle_in_flush.serve", ctx)
    assert idle_in == pytest.approx(100 * 0.4 / 2, abs=1e-4)
    from portbench.trace import union_length
    idle_all = 100 * (1 - union_length([(a, b) for a, b, _ in sl.device], lo, hi) / 2)
    assert idle_in <= idle_all
    for name in ("queue_wait_ms.serve", "assemble_ms.serve", "graph_host_ms.serve",
                 "idle_in_flush.serve"):
        assert runmod.read_metric(name, _ctx("train", sl)) is None
        assert runmod.read_metric(name, _ctx("serve", _slice([], 0, 0))) is None


def test_no_spans_no_reading(ring, monkeypatch):
    sl = _slice([(S, S + 1)], S, S + 1)
    names = ("queue_wait_ms.serve", "assemble_ms.serve", "graph_host_ms.serve",
             "idle_in_flush.serve")
    assert all(runmod.read_metric(n, _ctx("serve", sl)) is None for n in names)
    ring("serve.flush", S, S + 0.5)
    import facevae_tpu_torch                                              # a program without it
    monkeypatch.delattr(facevae_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "facevae_tpu_torch.tracing", None)
    assert spans.ring(S, S + 1) is None
    assert all(runmod.read_metric(n, _ctx("serve", sl)) is None for n in names)


def test_span_report_of_a_slice():
    from portbench import span_report
    sl = _slice([(0, 1), (1.2, 2.0), (2.6, 3), (5, 6)], 0, 6, _step_events())
    sl.busy_s, sl.units = 4.2, 1
    ring = [_span("serve.flush", 0.5, 3.5, sid=1), _span("serve.graph", 0.8, 1.8, sid=2, parent=1),
            _span("serve.queue", -1, -0.5, thread=2)]
    rep = span_report.report("serve-fp32-c16", {}, sl, ring)
    assert rep["host_ms"] == {"serve.flush": {"median": pytest.approx(3000), "count": 1},
                              "serve.graph": {"median": pytest.approx(1000), "count": 1}}
    assert rep["host_ms_before"] == {"serve.queue": {"median": pytest.approx(500), "count": 1}}
    assert rep["idle_s_by_innermost"] == pytest.approx({"serve.graph": 0.2, "serve.flush": 0.6,
                                                        "none": 2.0})
    assert rep["device_ms_outermost_remat.recompute."] == {"remat.recompute.mfe": 0.03}
    assert rep["device_ms_innermost"] == pytest.approx({"none": 0.06, "remat.recompute.mfe": 0.03})
    assert rep["heavy_device_ms"] == pytest.approx(0.09)
