"""PyTorch port: the serving slice end to end against facevae_tpu's
InferencePipeline (same bridged weights, tiny_config, batch 2, CPU), the
committed JAX golden that chip_smoke.py checks on the card, and the port's
HTTP server.

Tolerance: max|err| <= 1e-4 * max|ref| per output (fp32 on both sides; see
tests/test_torch_models.py for why it is not tighter).
"""
import threading
import urllib.request

import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.serve import BatchedEngine, start_server
from facevae_tpu_torch.train.inference import InferencePipeline
from torch_parity import assert_close, golden, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast
REL = 1e-4


def _port(cfg, variables, **kw):
    models = build_models(cfg.model, device="cpu")
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    return InferencePipeline(cfg, models, **kw)


@pytest.fixture(scope="module")
def env():
    cfg = tiny_config()
    variables = golden.g_variables(cfg, seed=5)
    rs = np.random.RandomState(11)
    size = cfg.model.image_size
    s, d = (rs.rand(2, size, size, 3).astype(np.float32) for _ in range(2))
    return dict(cfg=cfg, variables=variables, jax=golden.jax_pipeline(cfg, variables),
                port=_port(cfg, variables), s=s, d=d)


@pytest.fixture(scope="module")
def encoded(env):
    return env["jax"].encode_source(env["s"]), env["port"].encode_source(torch.from_numpy(env["s"]))


def test_encode_source(encoded):
    ref, port = encoded
    for name, p, r in zip(("fs", "kp_c", "kp_s", "Rs"), port, ref):
        assert_close(p, np.asarray(r), REL, name)


def test_drive_frame(env, encoded):
    ref, port = encoded
    out = env["port"].drive_frame(*port, torch.from_numpy(env["d"]))
    assert out.shape == env["d"].shape
    assert_close(out, np.asarray(env["jax"].drive_frame(*ref, env["d"])), REL, "drive_frame")


def test_drive_batch(env, encoded):
    ref, port = encoded
    one = [np.asarray(a)[:1] for a in ref]
    out = env["port"].drive_batch(*[a[:1] for a in port], torch.from_numpy(env["d"]))
    assert_close(out, np.asarray(env["jax"].drive_batch(*one, env["d"])), REL, "drive_batch")


def test_frontalize_frame(env):
    out = env["port"].frontalize_frame(torch.from_numpy(env["d"]))
    assert_close(out, np.asarray(env["jax"].frontalize_frame(env["d"])), REL, "frontalize")


def test_without_efe(env):
    """use_efe=False: the pose-only keypoints drive MFE (serve --use_efe false)."""
    ref_pipe = golden.jax_pipeline(env["cfg"], env["variables"])
    ref_pipe.use_efe = False                      # read when the graphs are traced
    port = InferencePipeline(env["cfg"], env["port"].models, use_efe=False)
    d = torch.from_numpy(env["d"])
    enc = port.encode_source(torch.from_numpy(env["s"]))
    ref_enc = ref_pipe.encode_source(env["s"])
    assert_close(port.drive_frame(*enc, d), np.asarray(ref_pipe.drive_frame(*ref_enc, env["d"])),
                 REL, "drive_frame without EFE")
    assert_close(port.frontalize_frame(d), np.asarray(ref_pipe.frontalize_frame(env["d"])),
                 REL, "frontalize without EFE")


def test_golden_is_reproduced():
    """The port (plain warp on the CPU) reproduces tests/data/torch_golden_tiny.npz,
    so the golden chip_smoke.py holds the card to cannot go stale unnoticed."""
    z = np.load(golden.GOLDEN)
    variables = nested_from_flat({k[len("var/"):]: z[k] for k in z.files if k.startswith("var/")})
    pipe = _port(tiny_config(), variables)
    enc = pipe.encode_source(torch.from_numpy(z["in/source"]))
    d = torch.from_numpy(z["in/driving"])
    outs = dict(zip(("fs", "kp_c", "kp_s", "Rs"), enc),
                drive=pipe.drive_frame(*enc, d), frontalize=pipe.frontalize_frame(d))
    for name, out in outs.items():
        assert_close(out, z["out/" + name], REL, name)


def _post(url, body):
    with urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                timeout=60) as r:
        return r.status, r.read()


def test_server_batches_requests(env):
    """The port's HTTP server: sessions, concurrent /drive requests batched
    to max_batch, /frontalize; on the CPU the warps take the plain path."""
    size = env["cfg"].model.image_size
    engine = BatchedEngine(env["port"], "cpu", max_batch=2, window_ms=2000.0)
    server = start_server(engine, "127.0.0.1", 0)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    rs = np.random.RandomState(0)
    frame = [rs.randint(0, 256, size * size * 3, dtype=np.uint8).tobytes() for _ in range(4)]
    try:
        fast_warp.reset_launch_counts()
        for sess in ("a", "b"):
            assert _post(f"{base}/source?session={sess}", frame[0])[0] == 200
        results = [None] * 4

        def go(i):
            results[i] = _post(f"{base}/drive?session={'ab'[i % 2]}", frame[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(code == 200 and len(body) == size * size * 3 for code, body in results)
        assert engine.stats == {"batches": 2, "frames": 4, "padded": 0}
        code, body = _post(f"{base}/frontalize", frame[1])
        assert code == 200 and len(body) == size * size * 3
        # per drive batch and frontalize: MFE's multi-grid warp and the
        # Generator's single-grid warp (fp32), both by their plain versions
        assert fast_warp.launches == {"warp_fwd": 0, "warp_fwd_plain": 3, "warp_bwd_dgrid": 0,
                                      "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 0,
                                      "warp_bwd_dx_plain": 0, "grid_fwd": 0,
                                      "grid_fwd_plain": 3, "grid_bwd_dgrid": 0,
                                      "grid_bwd_dgrid_plain": 0, "grid_bwd_dx": 0,
                                      "grid_bwd_dx_plain": 0}
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
