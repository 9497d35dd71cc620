"""Persistent batched inference server for the port (counterpart of the
root serve.py): ``python -m facevae_tpu_torch.serve --device cuda``.

Same endpoints, flags and batching as the JAX server, around the port's
InferencePipeline.  The request collector, the HTTP handler and the image
decoding are the port's own copies of the JAX server's (serve.py), with the
same behaviour, including how it waits before a second full batch of one
drain: max(0, min(window, 100 ms) - the first flush's time), nothing at
the default 10 ms window, which a full-width flush (~170 ms) outlasts:

  GET  /healthz                  -> {"ok": true, "batches": N, ...}
  POST /source?session=<id>      -> register/replace the session's source
  POST /drive?session=<id>       -> animate; returns the generated frame
  POST /frontalize               -> frontalize the posted frame (stateless)

Payloads are raw RGB bytes (H*W*3 uint8) or PNG (decoded by the port's own
reader, data/image_io.read_png); responses are raw RGB bytes.
Requests are collected into batches of --max_batch (padded), flushed when
full or when the oldest has waited --batch_window_ms.  The six G nets come
from the epoch file --ckp_dir/%08d-checkpoint.msgpack of epoch --ckp,
written by either package's save_checkpoint (train/checkpoint.py), or with
--random_init true from a seed.  --bf16 true is taken, as the JAX server
takes it, and serves fp32 all the same, as the JAX server does in practice
(its InferencePipeline never casts to the compute dtype); the server says
so when it starts:

    python -m facevae_tpu_torch.serve --ckp_dir ckp --ckp 12       # on the card
    python -m facevae_tpu_torch.serve --tiny true --image_size 64 \
        --ckp_dir ckp --ckp 0 --device cpu                        # plain versions
"""
from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from facevae_tpu_torch.config import Config, ModelConfig, tiny_config
from facevae_tpu_torch.convert import load_jax_variables, net_variables
from facevae_tpu_torch.data.dataset import to_rgb
from facevae_tpu_torch.data.image_io import PNG_SIGNATURE, read_png
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.train.checkpoint import read_checkpoint
from facevae_tpu_torch.train.inference import InferencePipeline


class HTTPServer(ThreadingHTTPServer):
    # socketserver's default listen backlog is 5: with more concurrent
    # clients the kernel drops their SYNs and they retry ~1 s later, which
    # stalled rounds of 16 concurrent /drive requests by ~1 s each.
    request_queue_size = 128


def _flag(s):
    return s.lower().startswith("t")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="face-vae PyTorch inference server")
    p.add_argument("--ckp_dir", type=str, default="ckp")
    p.add_argument("--ckp", type=int, default=0)
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--tiny", type=_flag, default=False)
    p.add_argument("--use_efe", type=_flag, default=True)
    p.add_argument("--port", type=int, default=8760)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--batch_window_ms", type=float, default=10.0)
    p.add_argument("--random_init", type=_flag, default=False,
                   help="seeded random weights instead of --ckp_dir/--ckp")
    p.add_argument("--bf16", type=_flag, default=False,
                   help="taken for the JAX server's flag; serving stays fp32")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


class BatchedEngine:
    """Collects requests per kind (drive / front) and runs each kind as one
    batch padded to max_batch: flushed when full or when its oldest request
    has waited window_ms.  Errors fan out to every request of the batch.
    Session encodings stay on the device at batch 1."""

    FLUSH_MS_KEPT = 4096

    def __init__(self, pipe: InferencePipeline, device, max_batch, window_ms):
        self.pipe = pipe
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.sessions = {}            # session id -> (fs, kp_c, kp_s, Rs), batch 1
        self.lock = threading.Lock()
        self.requests: "queue.Queue" = queue.Queue()
        self.stats = {"batches": 0, "frames": 0, "padded": 0}
        # host time of each of the last FLUSH_MS_KEPT batches, images in -> frames out
        self.flush_ms = collections.deque(maxlen=self.FLUSH_MS_KEPT)
        self._stop = False
        size = pipe.cfg.model.image_size
        self._zero = np.zeros((1, size, size, 3), np.float32)
        self.collector = threading.Thread(target=self._run, daemon=True)
        self.collector.start()

    def _tensor(self, imgs):
        return torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(self.device)

    # -- session management ------------------------------------------------
    def set_source(self, session, img):
        enc = self.pipe.encode_source(self._tensor(np.asarray(img)[None]))
        with self.lock:
            self.sessions[session] = enc

    def has_session(self, session):
        with self.lock:
            return session in self.sessions

    # -- request path ------------------------------------------------------
    def _submit(self, kind, session, img, timeout):
        done = threading.Event()
        slot = {}
        self.requests.put((kind, session, img, slot, done))
        if not done.wait(timeout):
            raise TimeoutError("inference timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["out"]

    def drive(self, session, img, timeout=30.0):
        """Blocking: returns the generated frame [H,W,3] float32."""
        return self._submit("drive", session, img, timeout)

    def frontalize(self, img, timeout=30.0):
        """Blocking; batched through the collector like /drive."""
        return self._submit("front", None, img, timeout)

    def warmup(self):
        """Run each batched graph once before serving traffic."""
        self.set_source("_warm", self._zero[0])
        self.drive("_warm", self._zero[0], timeout=3600.0)
        self.frontalize(self._zero[0], timeout=3600.0)
        with self.lock:
            self.sessions.pop("_warm", None)
        self.stats.update(batches=0, frames=0, padded=0)

    # -- collector ---------------------------------------------------------
    def _run(self):
        # Per-kind pending lists; a kind flushes when it reaches max_batch or
        # its oldest request has waited window_s; fuller kinds flush first.
        # Like the JAX collector, when a drain holds more than one batch of a
        # kind it resets that kind's deadline to now + window_s before the
        # flush, so the next full batch waits max(0, min(window_s, 0.1) -
        # the flush's time) for the queue's timeout.
        pending = {}              # kind -> [requests]
        deadlines = {}            # kind -> monotonic deadline of oldest request
        while not self._stop:
            timeout = 0.1
            if deadlines:
                timeout = min(0.1, max(0.0, min(deadlines.values())
                                       - time.monotonic()))
            try:
                req = self.requests.get(timeout=timeout)
            except queue.Empty:
                req = None
            while req is not None:   # drain everything already queued
                pending.setdefault(req[0], []).append(req)
                deadlines.setdefault(req[0], time.monotonic() + self.window_s)
                try:
                    req = self.requests.get_nowait()
                except queue.Empty:
                    req = None
            now = time.monotonic()
            ready = [k for k, b in pending.items()
                     if len(b) >= self.max_batch or now >= deadlines[k]]
            for kind in sorted(ready, key=lambda k: -len(pending[k])):
                batch = pending[kind][:self.max_batch]
                rest = pending[kind][self.max_batch:]
                if rest:
                    pending[kind] = rest
                    deadlines[kind] = time.monotonic() + self.window_s
                else:
                    del pending[kind], deadlines[kind]
                try:
                    self._flush(kind, batch)
                except Exception as e:                # fan the error out
                    for _, _, _, slot, done in batch:
                        slot["error"] = repr(e)
                        done.set()

    def _flush(self, kind, batch):
        t0 = time.perf_counter()
        n = len(batch)
        pad = self.max_batch - n
        imgs = self._tensor(np.concatenate(
            [np.asarray(img, np.float32)[None] for _, _, img, _, _ in batch]
            + [self._zero] * pad, axis=0))
        if kind == "drive":
            with self.lock:
                encs = [self.sessions[s] for _, s, _, _, _ in batch]
            fs, kp_c, kp_s, Rs = (torch.cat([e[i] for e in encs] + [encs[-1][i]] * pad)
                                  for i in range(4))
            out = self.pipe.drive_frame(fs, kp_c, kp_s, Rs, imgs)
        else:
            out = self.pipe.frontalize_frame(imgs)
        out = out.cpu().numpy()
        self.flush_ms.append((time.perf_counter() - t0) * 1e3)
        self.stats["batches"] += 1
        self.stats["frames"] += n
        self.stats["padded"] += pad
        for i, (_, _, _, slot, done) in enumerate(batch):
            slot["out"] = out[i]
            done.set()

    def stop(self):
        self._stop = True


def _decode_image(body, size):
    """Raw RGB bytes (size*size*3 uint8) or a PNG file -> [H,W,3] float32
    (grey stacked to RGB, alpha dropped)."""
    raw_len = size * size * 3
    if len(body) == raw_len:
        a = np.frombuffer(body, np.uint8).reshape(size, size, 3)
        return a.astype(np.float32) / 255.0
    if not body.startswith(PNG_SIGNATURE):
        raise ValueError(f"expected {raw_len} bytes of raw RGB or a PNG file, got "
                         f"{len(body)} bytes")
    a = to_rgb(read_png(body))
    if a.shape[:2] != (size, size):
        raise ValueError(f"expected {size}x{size}, got {a.shape}")
    return a[..., :3].astype(np.float32) / 255.0


def make_handler(engine, size):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):          # quiet
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if urlparse(self.path).path == "/healthz":
                self._json(200, {"ok": True, **engine.stats,
                                 "sessions": len(engine.sessions)})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            session = q.get("session", ["default"])[0]
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            try:
                img = _decode_image(body, size)
            except Exception as e:
                self._json(400, {"error": str(e)})
                return
            try:
                if u.path == "/source":
                    engine.set_source(session, img)
                    self._json(200, {"ok": True, "session": session})
                elif u.path == "/drive":
                    if not engine.has_session(session):
                        self._json(409, {"error": f"no source for session "
                                                  f"{session!r}; POST /source first"})
                        return
                    out = engine.drive(session, img)
                    self._send(200, (np.clip(out, 0, 1) * 255)
                               .astype(np.uint8).tobytes())
                elif u.path == "/frontalize":
                    out = np.asarray(engine.frontalize(img))
                    self._send(200, (np.clip(out, 0, 1) * 255)
                               .astype(np.uint8).tobytes())
                else:
                    self._json(404, {"error": "unknown path"})
            except Exception as e:
                self._json(500, {"error": repr(e)})

    return Handler


def build_engine(args) -> BatchedEngine:
    """Config, the six G nets on args.device (epoch args.ckp's file in
    args.ckp_dir, loaded strictly: params, batch_stats, spectral; or seeded
    random weights with args.random_init), pipeline and engine."""
    cfg = (tiny_config(image_size=args.image_size) if args.tiny
           else Config(model=ModelConfig(image_size=args.image_size)))
    device = torch.device(args.device)
    models = build_models(cfg.model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
    if not args.random_init:
        tree = read_checkpoint(args.ckp_dir, args.ckp)
        for name, m in models.items():
            load_jax_variables(m, net_variables(tree, name))
    pipe = InferencePipeline(cfg, models, use_efe=args.use_efe)
    return BatchedEngine(pipe, device, args.max_batch, args.batch_window_ms)


def start_server(engine: BatchedEngine, host: str, port: int) -> ThreadingHTTPServer:
    """Serve ``engine`` from a daemon thread; port 0 picks a free port
    (server.server_address).  Stop with server.shutdown(); engine.stop()."""
    server = HTTPServer((host, port), make_handler(engine, engine.pipe.cfg.model.image_size))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None):
    args = parse_args(argv)
    if args.bf16:
        print("--bf16 true: serving fp32 all the same (the JAX server's pipeline never "
              "casts to bf16)", flush=True)
    engine = build_engine(args)
    print("warming up ...", flush=True)
    engine.warmup()
    server = HTTPServer((args.host, args.port),
                        make_handler(engine, engine.pipe.cfg.model.image_size))
    print(f"serving on {args.host}:{args.port} on {engine.device} "
          f"(batch {args.max_batch}, window {args.batch_window_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
