"""The serving driver: the program's HTTP server (serve.py: the
BatchedEngine collector and the handler) with the benchmark's seeded
weights in its six nets, fed by a closed loop of clients in a load
generator process of its own (drivers/loadgen.py, no torch).

Set-up builds the engine, warms it up (engine.warmup: one drive and one
frontalize batch), starts the server on a free port, posts each session's
source, and hands the load generator its frames.  The window is the load
generator's ``seconds``; a traced run profiles a slice of traffic after it.
The engine's float frames of a seeded sample of its drive batches are kept
by wrapping the pipeline's drive_frame; after the window the program is
freed and the plain reference (serve_reference.py) judges them and a seeded
sample of the bytes the clients received.
"""
from __future__ import annotations

import gc
import hashlib
import http.client
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from typing import Dict

import numpy as np
import torch

from portbench import frames, seeds, weights
from portbench.trace import Slice
from portbench import serve_reference as sr


def program_config(config: Dict):
    from facevae_tpu_torch.config import Config, LossConfig, ModelConfig
    return Config(model=ModelConfig(**config.get("model", {})),
                  loss=LossConfig(**config.get("loss", {})))


def digest(a: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


class Keeper:
    """Wraps the pipeline's drive_frame, in the collector's thread: counts
    its calls from ``armed`` on, keeps the inputs and float outputs of the
    calls whose index is in ``keep``, and on ``trace(...)`` profiles the
    next calls there (the light profile over ``light`` calls, then the
    heavy one over ``heavy``)."""

    def __init__(self, fn, keep, is_cuda):
        self.fn, self.keep, self.is_cuda = fn, set(keep), is_cuda
        self.calls, self.armed, self.kept = 0, False, []
        self.phases, self.profiles, self.prof = [], [], None
        self.traced = threading.Event()

    def trace(self, light: int, heavy: int):
        self.phases = [("light", light), ("heavy", heavy)]

    def __call__(self, fs, kp_c, kp_s, Rs, img):
        from portbench import trace as tracing
        if self.prof is None and self.phases:
            kind, self.left = self.phases.pop(0)
            self.prof = (tracing.light_profile if kind == "light"
                         else tracing.heavy_profile)(self.is_cuda)
            self.prof.__enter__()
        out = self.fn(fs, kp_c, kp_s, Rs, img)
        if self.armed:
            if self.calls in self.keep:
                self.kept.append((img.detach().clone(), out.detach().clone()))
            self.calls += 1
        if self.prof is not None:
            self.left -= 1
            if self.left == 0:
                if self.is_cuda:
                    torch.cuda.synchronize()
                self.prof.__exit__(None, None, None)
                self.profiles.append(self.prof)
                self.prof = None
                if not self.phases:
                    self.traced.set()
        return out


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=body, headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    if resp.status != 200:
        raise RuntimeError(f"POST {path}: {resp.status} {data[:200]!r}")
    return data


def p95_with_failures(latencies, failed: int):
    """The 95th percentile of all requests, a failed one counting as
    missing every limit (infinite)."""
    allv = sorted(list(latencies) + [float("inf")] * failed)
    if not allv:
        return None
    i = max(0, int(np.ceil(0.95 * len(allv))) - 1)
    return allv[i]


def run(config: Dict, cell: Dict, seed: int, seconds: float, trace: bool, device,
        plant=None) -> Dict:
    from facevae_tpu_torch.models import build_models
    from facevae_tpu_torch.serve import BatchedEngine, start_server
    from facevae_tpu_torch.train.inference import InferencePipeline

    traffic = cell["traffic"]
    cfg = program_config(config)
    size = cfg.model.image_size
    is_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)

    models = build_models(cfg.model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    spec = sr.reference_nets(config, "meta")
    weights.load(models, weights.make(spec, seed, device))
    pipe = InferencePipeline(cfg, models, use_efe=True)
    keeper = Keeper(plant(pipe.drive_frame) if plant else pipe.drive_frame,
                    seeds.rng(seed, seeds.SAMPLE).choice(
                        traffic["keep_from"], traffic["keep_batches"], replace=False).tolist(),
                    is_cuda)
    pipe.drive_frame = keeper
    engine = BatchedEngine(pipe, device, traffic["max_batch"], traffic["window_ms"])
    engine.warmup()
    server = start_server(engine, "127.0.0.1", 0)
    port = server.server_address[1]

    n_sess, per = traffic["sessions"], traffic["frames_per_session"]
    clip = frames.smooth_clips(n_sess, per + 1, size, seed, traffic["grain"], device)
    clip = clip.reshape(n_sess, per + 1, size, size, 3).cpu().numpy()
    sources, driving = clip[:, 0], clip[:, 1:]
    for s in range(n_sess):
        _post(port, f"/source?session={s}", sources[s].tobytes())
    table = {digest(driving[s, f]): (s, f) for s in range(n_sess) for f in range(per)}

    head = {"port": port, "seconds": seconds, "traced": bool(trace),
            "seed": seeds.sub_seed(seed, seeds.SAMPLE, 1),
            "sessions": [c % n_sess for c in range(traffic["clients"])],
            "frames": per, "frame_bytes": size * size * 3, "sample": traffic["sample_answers"]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    gen = subprocess.Popen([sys.executable, "-m", "portbench.drivers.loadgen"],
                           stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
    try:
        gen.stdin.write((json.dumps(head) + "\n").encode())
        gen.stdin.write(driving.tobytes())
        gen.stdin.flush()
        if gen.stdout.readline().strip() != b"ready":
            raise RuntimeError("the load generator did not start")
        sync()
        if is_cuda:
            torch.cuda.reset_peak_memory_stats()
        stats0, flushes0 = dict(engine.stats), len(engine.flush_ms)
        keeper.armed = True
        window_start = time.time()
        t0 = time.monotonic()
        gen.stdin.write(b"go\n")
        gen.stdin.flush()
        time.sleep(max(0.0, seconds - (time.monotonic() - t0)))
        stats1, flush_ms = dict(engine.stats), list(engine.flush_ms)[flushes0:]
        result_slice = None
        if trace:
            keeper.trace(traffic["trace_batches"], 1)
            if not keeper.traced.wait(traffic["trace_timeout_s"]):
                raise RuntimeError("the traced slice did not finish")
            gen.stdin.write(b"stop\n")
            gen.stdin.flush()
            result_slice = Slice(keeper.profiles[0], keeper.profiles[1],
                                 traffic["trace_batches"])
        out, _ = gen.communicate(timeout=180)
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
        server.shutdown()
        server.server_close()
        engine.stop()
    if gen.returncode != 0:
        raise RuntimeError(f"the load generator exited with {gen.returncode}")
    report = json.loads(out)
    records = report["records"]
    in_window = [r for r in records if r[2] < seconds]
    ok = [r[3] - r[2] for r in in_window if r[4] == 200]
    failed = len(in_window) - len(ok)
    done_in_window = sum(1 for r in records if r[4] == 200 and r[3] <= seconds)
    p95 = p95_with_failures(ok, failed)
    result = {"window_start": window_start,
              "e2e": {"serve_frames_per_s": done_in_window / seconds},
              "attempted": len(in_window), "failed": failed,
              "facts": {"window_units": stats1["frames"] - stats0["frames"],
                        "window_s": seconds,
                        "frames": stats1["frames"] - stats0["frames"],
                        "batches": stats1["batches"] - stats0["batches"],
                        "max_batch": traffic["max_batch"], "flush_ms": flush_ms,
                        "p95_ms": None if p95 is None else 1e3 * p95},
              "notes": {"requests": len(in_window), "answered": len(ok),
                        "median_ms": 1e3 * statistics.median(ok) if ok else None,
                        "kept_batches": len(keeper.kept)}}
    if is_cuda:
        result["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    if result_slice is not None:
        result["slice"] = result_slice

    # what the reference judges: the kept batches' rows and the sampled answers
    kept_rows = []
    for img, out_f in keeper.kept:
        ins = (img.float() * 255).round().clamp(0, 255).to(torch.uint8).cpu().numpy()
        outs = out_f.float().cpu().numpy()
        for i in range(ins.shape[0]):
            key = table.get(digest(ins[i]))
            if key is not None:
                kept_rows.append((key, outs[i]))
    answers = []
    for idx, hexbytes in report["sample"]:
        s, f = records[idx][0], records[idx][1]
        answers.append(((s, f), np.frombuffer(bytes.fromhex(hexbytes), np.uint8)
                        .reshape(size, size, 3)))
    del keeper, pipe, engine, models, server
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    numbers, ref = sr.judge(config, seed, device, sources, driving, kept_rows, answers,
                            count_flops=trace)
    result["numbers"] = numbers
    result["facts"]["flops_per_unit"] = ref.get("flops_per_frame")
    result["readings"] = {"kept_rows": kept_rows, "answers": answers, "reference": ref,
                          "sources": sources, "driving": driving}
    result["notes"].update(rows_judged=len(kept_rows), answers_judged=len(answers))
    return result
