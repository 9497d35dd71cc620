"""PyTorch port: the evaluation path against facevae_tpu's on the CPU.

- FlattenVAE_NL and the conv5 EFE with train_vae=True, at
  tiny_config(image_size=128), whose EFE bottleneck is 2x2 with Cz = 16 (at
  64 px it is 1x1 and the flatten order cannot show): mu, logstd, x_hat and
  kp.  JAX's threefry draw cannot be reproduced in torch, so
  jax.random.normal as facevae_tpu.models.vae sees it is patched to return
  the eps the port is given.
- sample_expression (temperature 0, 0.5, 1) and interpolate_expression
  (alpha 0, 0.3, 1) against the JAX InferencePipeline, same bridged weights.
- The CLI, python -m facevae_tpu_torch.evaluate, against the root
  evaluate.py (loaded by path, the compile cache off, create_train_state
  giving a template of the saved state's structure) on one epoch file the
  JAX package wrote and one PNG tree: mode m's JSON, and the uint8 gif
  frames of modes r, f, i, p and <img> before encoding (the JAX CLI's
  captured at imageio.v2.mimsave).  Mode s: shapes only, its draws differ.
- Mode m in a subprocess with imageio, cv2 and pandas blocked (PNG frames
  decode through PIL, which the card's machine has).

Tolerances: model outputs max|err| <= 1e-4 * max|ref| (fp32 on both sides,
tests/test_torch_pipeline.py's REL); gif frames within 1 level of 255 (a
1e-4 difference can cross one truncation step); mode m's L1 and MSE within
1e-4 absolute plus the 1e-6 of their rounding, PSNR within 0.01 dB, the
counts and video names equal.
"""
import importlib.util
import json
import os
import subprocess
import sys

import imageio.v2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facevae_tpu.train
import facevae_tpu.utils
from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.models import build_models as jax_build_models
from facevae_tpu.models import vae as jax_vae
from facevae_tpu.models.vae import FlattenVAE_NL as JaxVAE
from facevae_tpu_torch import evaluate
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables
from facevae_tpu_torch.data.synthetic import write_dataset
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.models.vae import FlattenVAE_NL
from facevae_tpu_torch.train.inference import InferencePipeline
from torch_parity import ROOT, assert_close, fixed_normal, golden, one_torch_thread  # noqa: F401

REL = 1e-4
SIZE = 128
EPOCH = 3
FRAMES = 4


@pytest.fixture(scope="module")
def nets():
    """(cfg, JAX G-net variables, the JAX pipeline and the port's over them)
    at 128 px.  The JAX pipeline compiles each graph once for the module:
    every sample_expression call here patches in the same eps."""
    cfg = jax_tiny_config(image_size=SIZE)
    variables = golden.g_variables(cfg, seed=7)
    models = build_models(tiny_config(image_size=SIZE).model, device="cpu")
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    return (cfg, variables, golden.jax_pipeline(cfg, variables),
            InferencePipeline(tiny_config(image_size=SIZE), models))


def test_flatten_vae_samples_in_the_jax_order(monkeypatch):
    """mu, logstd flattened channel-last, z = mu + exp(logstd) * eps, at a
    2x3 map with Cz = 4; and z = mu without train_vae."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 2, 3, 8).astype(np.float32)                # [N,h,w,2Cz]
    eps = rs.randn(2, 2 * 3 * 4).astype(np.float32)
    monkeypatch.setattr(jax_vae, "jax", fixed_normal(eps))
    (mu, logstd), x_hat = JaxVAE().apply({}, jnp.asarray(x), True,
                                         rngs={"noise": jax.random.PRNGKey(0)})
    (pmu, plogstd), px_hat = FlattenVAE_NL()(torch.from_numpy(x).permute(0, 3, 1, 2), True,
                                            eps=torch.from_numpy(eps))
    np.testing.assert_allclose(pmu.numpy(), np.asarray(mu), rtol=0, atol=0)
    np.testing.assert_allclose(plogstd.numpy(), np.asarray(logstd), rtol=0, atol=0)
    assert_close(px_hat.permute(0, 2, 3, 1), np.asarray(x_hat), 1e-6, "x_hat")
    (none, _), mean = FlattenVAE_NL()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert none is None and torch.equal(mean.permute(0, 2, 3, 1), torch.from_numpy(x[..., :4]))
    with pytest.raises(ValueError, match="eps"):
        FlattenVAE_NL()(torch.from_numpy(x).permute(0, 3, 1, 2), True, eps=torch.zeros(2, 4))


def test_efe_samples_as_jax(nets, monkeypatch):
    """The conv5 EFE with train_vae at a 2x2 bottleneck: kp, mu, logstd,
    x_vae, x_hat; and drawing eps from a generator is drawing it by hand."""
    cfg, variables, _, pipe = nets
    rs = np.random.RandomState(2)
    img = rs.rand(2, SIZE, SIZE, 3).astype(np.float32)
    kp = rs.uniform(-0.5, 0.5, (2, cfg.model.num_kp, 3)).astype(np.float32)
    eps = rs.randn(2, 2 * 2 * 16).astype(np.float32)
    monkeypatch.setattr(jax_vae, "jax", fixed_normal(eps))
    ref = jax_build_models(cfg.model)["efe"].apply(
        variables["efe"], jnp.asarray(img), None, jnp.asarray(kp), train_vae=True, train=False,
        rngs={"noise": jax.random.PRNGKey(0)})
    efe = pipe.models["efe"]
    with torch.inference_mode():
        out = efe(torch.from_numpy(img), None, torch.from_numpy(kp), train_vae=True,
                  eps=torch.from_numpy(eps))
        drawn = efe(torch.from_numpy(img), None, torch.from_numpy(kp), train_vae=True,
                    generator=torch.Generator().manual_seed(5))
        by_hand = efe(torch.from_numpy(img), None, torch.from_numpy(kp), train_vae=True,
                      eps=torch.randn(2, 64, generator=torch.Generator().manual_seed(5)))
    assert out[3][0].shape == (2, 64)
    for name, p, r in (("kp", out[0], ref[0]), ("mu", out[3][0], ref[3][0]),
                       ("logstd", out[3][1], ref[3][1]), ("x_vae", out[4][0], ref[4][0]),
                       ("x_hat", out[4][1], ref[4][1])):
        assert_close(p, np.asarray(r), REL, name)
    assert torch.equal(drawn[0], by_hand[0])


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0])
def test_sample_expression(nets, temperature, monkeypatch):
    _, _, jax_pipe, pipe = nets
    rs = np.random.RandomState(3)
    img = rs.rand(2, SIZE, SIZE, 3).astype(np.float32)
    eps = rs.randn(2, 64).astype(np.float32)
    monkeypatch.setattr(jax_vae, "jax", fixed_normal(eps))
    ref = jax_pipe.sample_expression(
        img, jax.random.PRNGKey(0), jnp.asarray(temperature, jnp.float32))
    out = pipe.sample_expression(torch.from_numpy(img), temperature, eps=torch.from_numpy(eps))
    assert out.shape == img.shape
    assert_close(out, np.asarray(ref), REL, f"sample_expression T={temperature}")


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_interpolate_expression(nets, alpha):
    _, _, jax_pipe, pipe = nets
    rs = np.random.RandomState(4)
    s, d = (rs.rand(2, SIZE, SIZE, 3).astype(np.float32) for _ in range(2))
    ref = jax_pipe.interpolate_expression(
        s, d, jnp.asarray(alpha, jnp.float32))
    out = pipe.interpolate_expression(torch.from_numpy(s), torch.from_numpy(d),
                                      torch.tensor(alpha, dtype=torch.float32))
    assert_close(out, np.asarray(ref), REL, f"interpolate_expression alpha={alpha}")


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """One epoch file written by the JAX package (a numpy-seeded tiny_config
    state at 128 px), a PNG dataset tree, the root evaluate.py as a module,
    and the JAX template state."""
    cfg = jax_tiny_config(image_size=SIZE)
    _, variables = golden.train_variables(cfg, seed=17)
    jstate = golden.jax_train_state(cfg, variables)
    ckp_dir = str(tmp_path_factory.mktemp("jax_ckp"))
    facevae_tpu.train.save_checkpoint(ckp_dir, jstate, EPOCH)
    root = write_dataset(str(tmp_path_factory.mktemp("data") / "root"), SIZE, 2, FRAMES)
    spec = importlib.util.spec_from_file_location("root_evaluate", ROOT / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return dict(ckp_dir=ckp_dir, root=root, module=module, template=jstate,
                out=str(tmp_path_factory.mktemp("out")))


def _argv(cli, source, **extra):
    drive = cli["root"] if source in ("m", "p") else os.path.join(cli["root"], "test",
                                                                     "id0#clip0")
    argv = ["--ckp_dir", cli["ckp_dir"], "--ckp", str(EPOCH), "--tiny", "true",
            "--image_size", str(SIZE), "--source", source, "--driving", drive,
            "--output", os.path.join(cli["out"], "out.gif")]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return argv


def _jax_main(cli, argv):
    """The root CLI's main(argv) -> (its return value, the frames it saved)."""
    saved = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(facevae_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
        mp.setattr(facevae_tpu.train, "create_train_state", lambda cfg, seed=0: cli["template"])
        mp.setattr(imageio.v2, "mimsave", lambda path, frames, *a, **k: saved.extend(frames))
        out = cli["module"].main(argv)
    return out, saved


def _port_frames(argv):
    args = evaluate.parse_args(argv + ["--device", "cpu"])
    return evaluate.gif_frames(evaluate.build_pipeline(args), args)


def test_cli_metrics_match_the_jax_cli(cli, tmp_path):
    """Mode m at --eval_batch 2 (3 driven frames a video: the last chunk
    padded): the JSON record of the JAX CLI, printed and --metrics_out."""
    argv = _argv(cli, "m", eval_batch=2)
    ref, _ = _jax_main(cli, argv)
    port = evaluate.main(argv + ["--device", "cpu", "--metrics_out", str(tmp_path / "m.json")])
    assert json.loads((tmp_path / "m.json").read_text()) == port
    assert set(port) == set(ref)
    assert (port["frames"], port["videos"], port["metric"]) == (2 * (FRAMES - 1), 2, "recon_eval")
    for key in ("recon_l1", "recon_mse"):
        assert abs(port[key] - ref[key]) <= 1e-4 + 1e-6, key
    assert abs(port["psnr_db"] - ref["psnr_db"]) <= 0.01
    for k in ("p10", "p50", "p90"):
        assert abs(port["l1_dist"][k] - ref["l1_dist"][k]) <= 1e-4 + 1e-6
        assert abs(port["psnr_dist"][k] - ref["psnr_dist"][k]) <= 0.01
    for p, r in zip(port["per_video"], ref["per_video"], strict=True):
        assert (p["video"], p["frames"]) == (r["video"], r["frames"])
        assert abs(p["l1"] - r["l1"]) <= 1e-4 + 1e-6 and abs(p["mse"] - r["mse"]) <= 1e-4 + 1e-6
        assert abs(p["psnr_db"] - r["psnr_db"]) <= 0.01


@pytest.mark.parametrize("source", ["r", "f", "i", "p", "img"])
def test_cli_gif_frames_match_the_jax_cli(cli, source):
    """The uint8 gif frames before encoding, within 1 level."""
    if source == "img":
        source = os.path.join(cli["root"], "test", "id1#clip0", "0000002.png")
    argv = _argv(cli, source, num_pairs=2)
    _, ref = _jax_main(cli, argv)
    port = _port_frames(argv)
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert p.dtype == np.uint8 and p.shape == np.asarray(r).shape
        assert int(np.abs(p.astype(np.int16) - np.asarray(r, np.int16)).max()) <= 1


def test_cli_sample_writes_a_gif_of_the_frames(cli, tmp_path):
    """Mode s: one side-by-side frame per input frame, written as a gif,
    the sampled frames finite; its draws are the port's own (a CPU
    generator per frame), so the same on every device and not the JAX
    CLI's."""
    argv = _argv(cli, "s") + ["--device", "cpu", "--output", str(tmp_path / "s.gif")]
    evaluate.main(argv)
    data = (tmp_path / "s.gif").read_bytes()
    assert data[:6] == b"GIF89a"
    frames = imageio.v2.mimread(str(tmp_path / "s.gif"))
    assert len(frames) == FRAMES and frames[0].shape[:2] == (SIZE, 2 * SIZE)
    again = _port_frames(_argv(cli, "s"))
    assert len(again) == FRAMES and all(f.shape == (SIZE, 2 * SIZE, 3) for f in again)
    args = evaluate.parse_args(_argv(cli, "s") + ["--device", "cpu"])
    frame = torch.rand(1, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(0))
    out = evaluate.build_pipeline(args).sample_expression(
        frame, 1.0, generator=torch.Generator().manual_seed(0))
    assert out.shape == frame.shape and bool(torch.isfinite(out).all())


def test_cli_refuses_cuda_without_a_card(cli):
    """--device cuda on a machine without a card fails (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        evaluate.main(_argv(cli, "m"))


_BLOCKED = ("imageio", "cv2", "pandas")


def test_cli_metrics_need_no_imageio_cv2_or_pandas(cli):
    """Mode m on the PNG tree in a fresh interpreter where importing
    imageio, cv2 or pandas fails: the evaluation path imports none."""
    code = ("import json, sys\n"
            f"for name in {_BLOCKED!r}: sys.modules[name] = None\n"
            "from facevae_tpu_torch import evaluate\n"
            "out = evaluate.main(json.loads(sys.argv[1]))\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {_BLOCKED!r} "
            "and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    argv = _argv(cli, "m", eval_batch=2) + ["--device", "cpu"]
    # one intra-op thread, as the suite's other port tests (tests/torch_parity.py)
    res = subprocess.run([sys.executable, "-c", code, json.dumps(argv)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["frames"] == 2 * (FRAMES - 1) and np.isfinite(line["recon_l1"])
