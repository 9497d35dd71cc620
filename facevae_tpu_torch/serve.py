"""Persistent batched inference server for the port (counterpart of the
root serve.py): ``python -m facevae_tpu_torch.serve --device cuda``.

Same endpoints, flags and batching as the JAX server — it reuses that
server's request collector, HTTP handler and image decoding, which are
framework-free — around the port's InferencePipeline:

  GET  /healthz                  -> {"ok": true, "batches": N, ...}
  POST /source?session=<id>      -> register/replace the session's source
  POST /drive?session=<id>       -> animate; returns the generated frame
  POST /frontalize               -> frontalize the posted frame (stateless)

Payloads are raw RGB bytes (H*W*3 uint8) or PNG; responses are raw RGB bytes.
Requests are collected into batches of --max_batch (padded), flushed when
full or when the oldest has waited --batch_window_ms.  Loading checkpoints
is not ported yet, so the server needs --random_init true.
"""
from __future__ import annotations

import argparse
import queue
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import torch

import serve as _jax_serve        # root serve.py: stdlib-only at import time
from facevae_tpu.config import Config, ModelConfig, tiny_config
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.train.inference import InferencePipeline

make_handler = _jax_serve.make_handler


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
                   help="seeded random weights (checkpoint loading is not ported yet)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


class BatchedEngine(_jax_serve.BatchedEngine):
    """The JAX server's collector (per-kind queues, flush on full batch or
    window, padding to max_batch, error fan-out) driving the port's
    pipeline.  Session encodings stay on the device at batch 1."""

    def __init__(self, pipe: InferencePipeline, device, max_batch, window_ms):
        # the parent's __init__ builds the JAX pipeline; set its state here
        self.pipe = pipe
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.sessions = {}
        self.lock = threading.Lock()
        self.requests: "queue.Queue" = queue.Queue()
        self.stats = {"batches": 0, "frames": 0, "padded": 0}
        self.flush_ms = []            # host time of each batch, images in -> frames out
        self._stop = False
        size = pipe.cfg.model.image_size
        self._zero = np.zeros((1, size, size, 3), np.float32)
        self.collector = threading.Thread(target=self._run, daemon=True)
        self.collector.start()

    def _tensor(self, imgs):
        return torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(self.device)

    def set_source(self, session, img):
        enc = self.pipe.encode_source(self._tensor(np.asarray(img)[None]))
        with self.lock:
            self.sessions[session] = enc

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


def build_engine(args) -> BatchedEngine:
    """Config, seeded random models on args.device, pipeline and engine."""
    if not args.random_init:
        raise SystemExit("loading JAX checkpoints is not ported yet (ROADMAP "
                         "Queue 1); run with --random_init true")
    cfg = (tiny_config(image_size=args.image_size) if args.tiny
           else Config(model=ModelConfig(image_size=args.image_size)))
    device = torch.device(args.device)
    models = build_models(cfg.model, device=device,
                          generator=torch.Generator(device=device).manual_seed(0))
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
