"""The reader of overlap_share.serve on synthetic rings: a collector that
answers each batch before it takes the next reads 0, one that dispatches
every batch behind the last reads 100, and nothing is read without spans."""
from __future__ import annotations

import types

import pytest

from portbench import run as runmod

S = 1_700_000_000.0            # a slice's start, seconds on the Unix clock


@pytest.fixture
def flush(monkeypatch):
    """The program's ring, emptied for the test; ``flush(a, b, graph_at)``
    records a batch's serve.flush span and its serve.graph child."""
    from facevae_tpu_torch import tracing
    monkeypatch.setattr(tracing, "RING", tracing.Ring(1 << 10))

    def add(a, b, graph_at):
        ns = lambda t: int(round((S + t) * 1e9))          # noqa: E731
        fid = tracing.record("serve.flush", ns(a), ns(b))
        tracing.record("serve.graph", ns(graph_at), ns(graph_at + 0.05), parent=fid)
    return add


def _read(lo, hi, kind="serve"):
    sl = types.SimpleNamespace(device=[], lo=S + lo, hi=S + hi, window_s=hi - lo)
    ctx = types.SimpleNamespace(kind=kind, slice=sl, facts={}, config={})
    return runmod.read_metric("overlap_share.serve", ctx)


def test_serial_flushes_read_0(flush):
    for k in range(4):
        flush(k, k + 0.9, k + 0.1)
    assert _read(0.5, 4) == 0.0


def test_flushes_behind_another_read_100(flush):
    flush(0.0, 1.5, 0.1)                  # its graph starts before the slice
    flush(0.6, 2.5, 0.7)
    flush(1.6, 3.5, 1.7)
    flush(3.6, 4.0, 3.7)                  # after the slice
    assert _read(0.5, 3.0) == 100.0
    assert _read(0.5, 4.0) == pytest.approx(200 / 3)    # the last goes behind none


def test_nothing_read_without_spans(flush):
    assert _read(0, 1) is None
    flush(0, 1, 0.1)
    assert _read(0, 1, kind="train") is None
    assert _read(2, 3) is None
