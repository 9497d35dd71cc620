"""PyTorch port: the serving engine's two batches in flight (serve.py,
BatchedEngine), on the CPU.

With a pipeline whose batches the test finishes (held_pipeline.py): a full
batch goes while one is in flight, never a third; a batch due only by its
window waits for an idle engine; an error reaches its own batch's requests
only; ``overlapped`` counts the batches dispatched behind another, is reset
by the warm-up and reported by /healthz.  With the tiny pipeline: every
request of three full batches gets its own frame, bit for bit the
pipeline's on the same stacked batch.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.serve import BatchedEngine, start_server
from facevae_tpu_torch.train.inference import InferencePipeline
from held_pipeline import HeldPipeline
from torch_parity import one_torch_thread  # noqa: F401

LONG_MS = 60_000.0             # a window no test waits out: only full batches go


def frame(k, size=4):
    return np.full((size, size, 3), float(k), np.float32)


class Ask:
    """One request from a thread of its own: ``out`` or ``error`` once done."""

    def __init__(self, call, *args):
        self.out = self.error = None
        self.thread = threading.Thread(target=self._run, args=(call, args), daemon=True)
        self.thread.start()

    def _run(self, call, args):
        try:
            self.out = call(*args, timeout=30)
        except RuntimeError as e:
            self.error = str(e)

    def result(self):
        self.thread.join(30)
        assert not self.thread.is_alive()
        return self.out, self.error


def until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.005)


def still(cond, seconds=0.3):
    """cond holds all through ``seconds``."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        assert cond()
        time.sleep(0.005)


@pytest.fixture
def held():
    """(pipeline, engine factory); the engines are stopped after the test."""
    pipe, engines = HeldPipeline(), []

    def make(max_batch=2, window_ms=LONG_MS):
        engines.append(BatchedEngine(pipe, "cpu", max_batch, window_ms))
        return engines[-1]
    yield pipe, make
    for e in engines:
        e.stop()


def test_a_full_batch_goes_behind_one_in_flight_and_never_a_third(held):
    pipe, make = held
    engine = make()
    engine.set_source("s", frame(10))
    first = [Ask(engine.frontalize, frame(k)) for k in (1, 2)]
    until(lambda: len(pipe.batches) == 1)
    second = [Ask(engine.drive, "s", frame(k)) for k in (3, 4)]     # the kinds share the limit
    until(lambda: len(pipe.batches) == 2)
    assert engine.overlapped == 1
    third = [Ask(engine.frontalize, frame(k)) for k in (5, 6)]
    still(lambda: len(pipe.batches) == 2)
    pipe.release(0)
    assert [a.result()[0][0, 0, 0] for a in first] == [2.0, 4.0]
    until(lambda: len(pipe.batches) == 3)                           # behind the second
    assert engine.overlapped == 2 and second[0].out is None
    pipe.release(1)
    pipe.release(2)
    assert [a.result()[0][0, 0, 0] for a in second] == [13.0, 14.0]
    assert [a.result()[0][0, 0, 0] for a in third] == [10.0, 12.0]
    assert engine.stats == {"batches": 3, "frames": 6, "padded": 0}
    assert len(engine.flush_ms) == 3


def test_a_batch_due_by_its_window_waits_for_an_idle_engine(held):
    pipe, make = held
    engine = make(window_ms=20.0)
    lone = Ask(engine.frontalize, frame(1))             # nothing in flight: goes at the window
    until(lambda: len(pipe.batches) == 1)
    pipe.release(0)
    assert lone.result()[0][0, 0, 0] == 2.0
    full = [Ask(engine.frontalize, frame(k)) for k in (2, 3)]
    until(lambda: len(pipe.batches) == 2)
    late = Ask(engine.frontalize, frame(4))             # due after 20 ms, one in flight
    still(lambda: len(pipe.batches) == 2)
    pipe.release(1)
    until(lambda: len(pipe.batches) == 3)
    assert [a.result()[0][0, 0, 0] for a in full] == [4.0, 6.0]
    assert pipe.batches[2][:, 0, 0, 0].tolist() == [4.0, 0.0]     # padded with zeros
    pipe.release(2)
    assert late.result()[0][0, 0, 0] == 8.0
    assert engine.overlapped == 0
    assert engine.stats == {"batches": 3, "frames": 4, "padded": 2}


def test_a_lone_request_of_the_other_kind_is_not_starved(held):
    """Four closed-loop /drive clients keep two full drive batches in flight,
    the card's time on a batch 50 ms; a lone /frontalize posted among them
    goes within a couple of batches, not when the stream stops."""
    pipe, make = held
    engine = make(window_ms=10.0)
    engine.set_source("s", frame(10))
    stop = threading.Event()

    def client():
        while not stop.is_set():
            engine.drive("s", frame(1), timeout=30)

    def card():
        k = 0
        while not stop.is_set():
            if len(pipe.batches) > k:
                time.sleep(0.05)
                pipe.release(k)
                k += 1
            else:
                time.sleep(0.002)

    threads = [threading.Thread(target=f, daemon=True) for f in [client] * 4 + [card]]
    for t in threads:
        t.start()
    try:
        until(lambda: len(pipe.batches) >= 4)
        posted = len(pipe.batches)
        lone = Ask(engine.frontalize, frame(9))
        until(lambda: lone.out is not None or lone.error is not None, timeout=5.0)
        assert lone.out[0, 0, 0] == 18.0
        went = next(i for i, b in enumerate(pipe.batches) if b[0, 0, 0, 0] == 9.0)
        assert went <= posted + 3, (posted, went)
    finally:
        stop.set()
        pipe.released = True
        for gate in pipe.gates:
            gate.set()
        for t in threads:
            t.join(30)


@pytest.mark.parametrize("where", ["dispatch", "readback"])
def test_an_error_reaches_its_own_batch_only(held, where):
    pipe, make = held
    failing = 1 if where == "dispatch" else 0
    (pipe.fail_dispatch if where == "dispatch" else pipe.fail_readback).add(failing)
    engine = make()
    first = [Ask(engine.frontalize, frame(k)) for k in (1, 2)]
    until(lambda: len(pipe.batches) == 1)
    second = [Ask(engine.frontalize, frame(k)) for k in (3, 4)]
    until(lambda: len(pipe.batches) == 2)
    if where == "dispatch":                             # answered while batch 0 is held
        assert all(f"batch 1 failed in {where}" in a.result()[1] for a in second)
        assert first[0].out is None and first[0].error is None
    pipe.release(0)
    pipe.release(1)
    results = [a.result() for a in first + second]
    for i, (out, error) in enumerate(results):
        if i // 2 == failing:
            assert out is None and f"batch {failing} failed in {where}" in error
        else:
            assert error is None and out[0, 0, 0] == 2.0 * (i + 1)
    pipe.released = True
    after = [Ask(engine.frontalize, frame(k)) for k in (5, 6)]       # the engine serves on
    assert [a.result()[0][0, 0, 0] for a in after] == [10.0, 12.0]
    assert engine.stats["batches"] == 2
    assert engine.overlapped == (0 if where == "dispatch" else 1)


def test_overlapped_is_reported_and_reset_by_the_warmup(held):
    pipe, make = held
    engine = make(window_ms=20.0)
    server = start_server(engine, "127.0.0.1", 0)
    try:
        asks = [Ask(engine.frontalize, frame(k)) for k in range(4)]
        until(lambda: len(pipe.batches) == 2)
        url = "http://127.0.0.1:%d/healthz" % server.server_address[1]
        with urllib.request.urlopen(url, timeout=30) as r:
            health = json.loads(r.read())
        assert health["overlapped"] == 1 and health["batches"] == 0
        assert "overlapped" not in engine.stats
        pipe.released = True
        pipe.release(0)
        pipe.release(1)
        assert all(a.result()[1] is None for a in asks)
        engine.warmup()
        assert engine.overlapped == 0 and engine.stats == {"batches": 0, "frames": 0, "padded": 0}
    finally:
        server.shutdown()
        server.server_close()


def test_answers_of_overlapped_batches_are_the_pipelines_own():
    """Three full drive batches of the tiny pipeline through the engine: each
    request's frame is, bit for bit, its row of drive_frame called directly
    on its batch as the engine stacks it (sessions' encodings, frames)."""
    cfg = tiny_config()
    size = cfg.model.image_size
    models = build_models(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    pipe = InferencePipeline(cfg, models)
    rs = np.random.RandomState(3)
    sources = {s: rs.rand(size, size, 3).astype(np.float32) for s in "ab"}
    frames = [rs.rand(size, size, 3).astype(np.float32) for _ in range(6)]
    engine = BatchedEngine(pipe, "cpu", max_batch=2, window_ms=LONG_MS)
    calls = []
    plain = pipe.drive_frame

    def keep(*args):
        calls.append(args[-1].clone())
        return plain(*args)
    pipe.drive_frame = keep
    try:
        for s, img in sources.items():
            engine.set_source(s, img)
        asks = [Ask(engine.drive, "ab"[i % 2], img) for i, img in enumerate(frames)]
        got = [a.result() for a in asks]
    finally:
        engine.stop()
    assert all(error is None for _, error in got) and len(calls) == 3
    for imgs in calls:
        rows = [next(i for i, f in enumerate(frames) if np.array_equal(f, r.numpy()))
                for r in imgs]
        sess = ["ab"[i % 2] for i in rows]
        fs, kp_c, kp_s, Rs = (torch.cat([engine.sessions[s][j] for s in sess]) for j in range(4))
        want = plain(fs, kp_c, kp_s, Rs, torch.from_numpy(np.stack([frames[i] for i in rows])))
        for k, i in enumerate(rows):
            assert np.array_equal(got[i][0], want[k].numpy())
