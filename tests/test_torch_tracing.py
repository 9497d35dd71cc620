"""PyTorch port: the span ring (facevae_tpu_torch/tracing.py) and the spans
of the serving and training layers, on the CPU; one clock check on the card.

The ring is bounded and safe from many threads, and a span's parent is the
enclosing span of its own thread.  Spans are stamped on the profiler's
clock, open a record_function only in a thread that profiles, and a
profile of a remat step shows each region's recompute while the step's
losses and gradients stay those of the step without a profiler.  The tiny
engine's spans of one /drive request share its id, its queue span ends at
its flush's start, flush_ms is the flush spans' durations, and /healthz
summarizes the serve.* spans; two batches in flight at once keep a flush
and three children each.

This file imports no JAX; the card's test runs with
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q -m cuda
"""
import copy
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from facevae_tpu_torch import tracing
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.serve import BatchedEngine, start_server
from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
from facevae_tpu_torch.train.inference import InferencePipeline
from facevae_tpu_torch.train.loop import _union_ns
from held_pipeline import HeldPipeline
from torch_parity import one_torch_thread  # noqa: F401


@pytest.fixture
def ring(monkeypatch):
    """A ring of the test's own in the module's place."""
    r = tracing.Ring(1 << 16)
    monkeypatch.setattr(tracing, "RING", r)
    return r


def _kineto(prof, name):
    return [e for e in prof.profiler.kineto_results.events() if e.name() == name]


# ------------------------------------------------------------------ the ring

def test_the_ring_is_bounded_and_keeps_the_newest(monkeypatch):
    assert tracing.RING.maxlen == tracing.RING_SPANS == 1 << 16
    monkeypatch.setattr(tracing, "RING", tracing.Ring(16))
    for i in range(100):
        with tracing.span("t.bounded", trace_id=i):
            pass
    kept = tracing.spans()
    assert len(kept) == 16 and [s.trace_id for s in kept] == list(range(84, 100))


def test_parents_nest_per_thread_under_many_threads(ring):
    """16 threads each open an outer span with two inner ones, 200 times,
    switching every microsecond: every span is kept once, ids are unique,
    each inner span's parent is its own thread's outer span and lies inside
    it, and trace ids pass from parent to child."""
    threads, rounds = 16, 200
    errors = []

    def work(k):
        try:
            for r in range(rounds):
                with tracing.span("t.outer", trace_id=k * rounds + r) as outer:
                    for _ in range(2):
                        with tracing.span("t.inner") as inner:
                            assert inner.parent == outer.id
        except AssertionError as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    got = tracing.spans()
    assert len(got) == threads * rounds * 3 and len({s.id for s in got}) == len(got)
    outer = {s.id: s for s in got if s.name == "t.outer"}
    assert len({s.thread for s in outer.values()}) == threads
    for s in got:
        if s.name == "t.inner":
            p = outer[s.parent]
            assert p.thread == s.thread and s.trace_id == p.trace_id
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert tracing.current() is None


def test_record_current_window_and_summary(ring):
    with tracing.span("serve.outer", trace_id=7) as outer:
        assert tracing.current() is outer
        sid = tracing.record("serve.kept", 1_000, 3_000_000, parent=outer.id, link=9)
    assert tracing.current() is None
    kept = {s.name: s for s in tracing.spans()}
    assert kept["serve.kept"].id == sid and kept["serve.kept"].link == 9
    assert kept["serve.kept"].thread == kept["serve.outer"].thread
    assert [s.name for s in tracing.spans(0, 2_000)] == ["serve.kept"]
    assert tracing.spans(3_000_001, 3_000_002) == []
    for ms in (1, 2, 3, 4):
        tracing.record("serve.x", 0, ms * 1_000_000)
    tracing.record("other.y", 0, 1)
    summary = tracing.summary("serve.")
    assert set(summary) == {"serve.outer", "serve.kept", "serve.x"}
    assert summary["serve.x"] == {"count": 4, "p50_ms": 2.0, "p95_ms": 4.0}


# ------------------------------------------------------- the profiler's clock

def test_spans_are_on_the_profilers_clock_and_open_record_function_there(ring):
    """Under a CPU profile the span's record_function range encloses the
    span's own clock reads; a second thread, which does not profile, opens
    none, and records its span all the same."""
    assert not torch._C._autograd._profiler_enabled()
    other = []

    def off_thread():
        other.append(torch._C._autograd._profiler_enabled())
        with tracing.span("t.other_thread"):
            torch.ones(4).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("t.profiled") as s:
            torch.ones(8).sum()
        t = threading.Thread(target=off_thread)
        t.start()
        t.join(timeout=60)
    assert other == [False] and not t.is_alive()
    (ev,) = _kineto(prof, "t.profiled")
    assert ev.start_ns() <= s.start_ns <= s.end_ns <= ev.end_ns()
    assert ev.is_user_annotation()
    assert _kineto(prof, "t.other_thread") == []
    assert {x.name for x in tracing.spans()} == {"t.profiled", "t.other_thread"}


def test_no_record_function_without_a_profiler(ring, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    with tracing.span("t.plain"):
        pass
    assert opened == [] and [s.name for s in tracing.spans()] == ["t.plain"]


def test_union_of_device_intervals_counts_overlap_once():
    assert _union_ns([(0, 10), (5, 20), (30, 40), (35, 38)], 0, 100) == 30
    assert _union_ns([(0, 10), (5, 20), (30, 40)], 8, 32) == 14
    assert _union_ns([], 0, 5) == 0


# ----------------------------------------------------------------- training

def test_remat_step_profile_shows_recomputes_and_changes_nothing(monkeypatch):
    """A tiny remat step with and without a CPU profile: the profile holds
    the step's phases, every net's span and each rematerialized net's
    recompute; both steps' losses and gradients agree bit for bit."""
    cfg = tiny_config()
    assert cfg.model.remat
    nets = build_all_modules(cfg, "cpu")
    rs = np.random.RandomState(3)
    batch = tuple(torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)) for _ in range(4))

    def step(prof_on):
        state = create_train_state(cfg, "cpu", copy.deepcopy(nets))
        g = torch.Generator().manual_seed(5)
        if not prof_on:
            return state, train_step(state, batch, generator=g), None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = train_step(state, batch, generator=g)
        return state, out, prof

    plain_state, plain, _ = step(False)
    monkeypatch.setattr(tracing, "RING", tracing.Ring(1 << 16))     # the profiled step's spans
    prof_state, profiled, prof = step(True)
    for phase in ("losses_g", "losses_d"):
        for k in plain[phase]:
            assert torch.equal(plain[phase][k], profiled[phase][k]), (phase, k)
    n = 0
    for name, net in plain_state.nets.items():
        theirs = dict(prof_state.nets[name].named_parameters())
        for k, p in net.named_parameters():
            if p.grad is not None:
                assert torch.equal(p.grad, theirs[k].grad), f"{name}.{k}"
                n += 1
    assert n > 100

    names = {e.name for e in prof.events()}
    remats = {"ckd", "hpe_ede", "efe", "mfe", "generator", "discriminator", "perceptual"}
    assert {f"remat.recompute.{n}" for n in remats} <= names
    assert {f"net.{n}" for n in remats | {"afe", "tps", "hopenet", "contrastive"}} <= names
    phases = {"train.step", "train.aug", "train.g_forward", "train.g_backward", "train.g_adam",
              "train.d_forward", "train.d_backward", "train.d_adam"}
    assert phases - {"train.aug"} <= names

    got = tracing.spans()
    assert {s.trace_id for s in got} == {0}
    by_id = {s.id: s for s in got}
    (top,) = [s for s in got if s.name == "train.step"]
    backward = [s for s in got if s.name in ("train.g_backward", "train.d_backward")]
    assert len(backward) == 2 and all(s.parent == top.id for s in backward)
    recomputes = [s for s in got if s.name.startswith("remat.recompute.")]
    assert recomputes and all(by_id[s.parent].name.endswith("_backward") for s in recomputes)
    assert sum(s.name == "net.efe" for s in got) == 3


# ------------------------------------------------------------------ serving

def _post(url, body):
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                timeout=120) as r:
        return r.status, r.read()


@pytest.fixture(scope="module")
def server():
    cfg = tiny_config()
    models = build_models(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    engine = BatchedEngine(InferencePipeline(cfg, models), "cpu", max_batch=2, window_ms=1.0)
    srv = start_server(engine, "127.0.0.1", 0)
    try:
        yield engine, "http://127.0.0.1:%d" % srv.server_address[1], cfg.model.image_size
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()


def test_one_drive_requests_spans_share_its_id(server, ring):
    engine, base, size = server
    frame = np.random.RandomState(0).randint(0, 256, size * size * 3, dtype=np.uint8).tobytes()
    assert _post(f"{base}/source?session=a", frame)[0] == 200
    engine.flush_ms.clear()
    code, body = _post(f"{base}/drive?session=a", frame)
    assert code == 200 and len(body) == size * size * 3

    got = tracing.spans()
    (req,) = [s for s in got if s.name == "serve.request" and s.trace_id is not None
              and any(c.name == "serve.wait" and c.parent == s.id for c in got)]
    mine = [s for s in got if s.trace_id == req.trace_id]
    names = {s.name for s in mine}
    assert names == {"serve.request", "serve.decode", "serve.wait", "serve.encode",
                     "serve.queue"}
    for s in mine:
        if s.name not in ("serve.request", "serve.queue"):
            assert s.parent == req.id and req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
    (queue,) = [s for s in mine if s.name == "serve.queue"]
    (flush,) = [s for s in got if s.name == "serve.flush"]
    assert queue.parent == req.id and queue.link == flush.trace_id
    assert queue.end_ns == flush.start_ns and queue.thread == flush.thread != req.thread
    children = {s.name for s in got if s.parent == flush.id}
    assert children == {"serve.assemble", "serve.graph", "serve.readback"}
    (graph,) = [s for s in got if s.name == "serve.graph"]
    assert [s.name for s in got if s.parent == graph.id] == \
        ["net.hpe_ede", "net.efe", "net.mfe", "net.generator"]
    assert list(engine.flush_ms) == [(flush.end_ns - flush.start_ns) / 1e6]
    # encode_source's nets, inside /source's request span
    (source,) = [s for s in got if s.name == "serve.request" and s.id != req.id]
    assert [s.name for s in got if s.parent == source.id and s.name.startswith("net.")] == \
        ["net.afe", "net.ckd", "net.hpe_ede", "net.efe"]


def test_healthz_summarizes_the_serve_spans(server, ring):
    engine, base, size = server
    frame = np.zeros(size * size * 3, np.uint8).tobytes()
    assert _post(f"{base}/source?session=h", frame)[0] == 200
    for _ in range(3):
        assert _post(f"{base}/drive?session=h", frame)[0] == 200
    with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    spans = health["spans"]
    assert set(spans) == {"serve.request", "serve.decode", "serve.wait", "serve.encode",
                          "serve.queue", "serve.flush", "serve.assemble", "serve.graph",
                          "serve.readback"}
    assert spans["serve.request"]["count"] == 4 and spans["serve.flush"]["count"] == 3
    for v in spans.values():
        assert 0 <= v["p50_ms"] <= v["p95_ms"]


def test_overlapped_batches_keep_their_own_spans(ring):
    """Two full batches, the second dispatched while the first is held in
    flight: the flushes overlap, each has its own assemble, graph and
    readback (the completer's), its requests' queue spans end at its start,
    and flush_ms is the flush spans' durations."""
    pipe = HeldPipeline()
    engine = BatchedEngine(pipe, "cpu", max_batch=2, window_ms=60_000.0)

    def ask(k):
        return threading.Thread(target=engine.frontalize,
                                args=(np.full((4, 4, 3), k, np.float32),), daemon=True)
    try:
        threads = []
        for n in (1, 2):
            threads += [ask(k) for k in range(2)]
            for t in threads[-2:]:
                t.start()
            for _ in range(2000):
                if len(pipe.batches) == n:
                    break
                threading.Event().wait(0.005)
        assert len(pipe.batches) == 2 and engine.overlapped == 1
        pipe.release(0)
        pipe.release(1)
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        engine.stop()
    got = tracing.spans()
    flushes = sorted((s for s in got if s.name == "serve.flush"), key=lambda s: s.start_ns)
    assert len(flushes) == 2 and flushes[1].start_ns < flushes[0].end_ns
    for flush in flushes:
        children = {s.name: s for s in got if s.parent == flush.id}
        assert set(children) == {"serve.assemble", "serve.graph", "serve.readback"}
        for c in children.values():
            assert flush.start_ns <= c.start_ns <= c.end_ns <= flush.end_ns
        assert children["serve.readback"].thread != flush.thread == children["serve.graph"].thread
        queues = [s for s in got if s.name == "serve.queue" and s.link == flush.trace_id]
        assert len(queues) == 2 and all(q.end_ns == flush.start_ns for q in queues)
    assert list(engine.flush_ms) == [(f.end_ns - f.start_ns) / 1e6 for f in flushes]


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
def test_span_encloses_its_launch_under_the_light_profile(ring):
    """Under a CUDA-only profile (the benchmark's light slice) a span around
    one kernel launch encloses that launch's runtime call to within 50 us:
    the program's spans and the profile's events share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.ones(1 << 20, device="cuda")
    (x * 2).sum()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.span("t.launch") as s:
            y = x * 2
        torch.cuda.synchronize()
    launches = [e for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CPU and "LaunchKernel" in e.name()]
    assert len(launches) == 1, [e.name() for e in launches]
    (call,) = launches
    assert s.start_ns - 50_000 <= call.start_ns() <= call.end_ns() <= s.end_ns + 50_000
    assert float(y[0]) == 2.0
