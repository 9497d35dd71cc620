"""PyTorch port: the training runtime (train/logger.py, train/loop.py,
train/cli.py) against the JAX package and the root train.py, on the CPU.

- ScalarLog: the add.txt files of the two packages on the same loss
  sequence (K zero throughout, and K nonzero on some steps) are equal byte
  for byte.
- Visualizer: the epoch image equals the JAX package's on the same inputs;
  the port's gist_rainbow table equals matplotlib's; the saved PNG reads
  back as the image.
- build_config equals the root train.py's, field for field, for several
  argvs; every flag of the root CLI parses on the port's to the same value.
- The CLI at tiny_config on --device cpu over a PNG tree: two epochs (the
  log's two G / D pairs with the K column, two visualizations, one epoch
  file kept), a resume with --ckp -1 (epoch 2, step 2, with --tensorboard),
  and a resume with --ckp N from an epoch file the JAX package's
  save_checkpoint wrote, whose next epoch file the JAX package loads back.
- The crash-save: a KeyboardInterrupt from the loader stops the loop and
  saves; an exception from the loader after a step saves the stepped state
  and is raised again.
- The refusals: --device cuda without a card ("no CUDA device"),
  --steps_per_call > 1 without --device_cache, --gpu_ids of more cards
  than the machine has, --device_cache with --cpu_aug.
- The prefetch thread and the metric buffer on the CPU: batches in order,
  a loader error raised to the consumer, every loss logged in order; the
  --profile_dir trace written.
"""
import dataclasses
import importlib.util
import os

import imageio.v2 as imageio
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from facevae_tpu import train as jtrain
from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.train import logger as jax_logger
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.data.synthetic import write_training_tree
from facevae_tpu_torch.train import checkpoint, cli, create_train_state, logger, loop
from torch_parity import ROOT, golden, one_torch_thread  # noqa: F401

matplotlib.use("Agg")


def _root_train():
    spec = importlib.util.spec_from_file_location("root_train", ROOT / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _losses(rs, k_every):
    """A step's loss dicts as the JAX step returns them (alphabetized keys)."""
    g = {n: float(rs.rand()) for n in sorted("PGFELHDCKR")}
    g["K"] = float(rs.rand()) if k_every and rs.rand() < 0.5 else 0.0
    return g, {"G1": float(rs.rand()), "G2": float(rs.rand())}


@pytest.mark.parametrize("k_every", [False, True], ids=["k_zero", "k_nonzero"])
def test_scalar_log_matches_the_jax_package(k_every, tmp_path):
    rs = np.random.RandomState(int(k_every))
    logs = {"port": logger.ScalarLog(str(tmp_path / "port" / "log.txt")),
            "jax": jax_logger.ScalarLog(str(tmp_path / "jax" / "log.txt"))}
    for epoch in range(3):
        for _ in range(5):
            g, d = _losses(rs, k_every)
            for log in logs.values():
                log.log_iter(g, d)
        for log in logs.values():
            log.log_epoch(epoch)
    for log in logs.values():
        log.close()
    port = (tmp_path / "port" / "log.txt").read_bytes()
    assert port == (tmp_path / "jax" / "log.txt").read_bytes()
    assert port.count(b"G0000000") == 3 and port.count(b"D0000000") == 3
    assert (port.count(b"K - nan") < 3) == k_every    # q4: nan where K never fired


def test_visualizer_matches_the_jax_package(tmp_path):
    rs = np.random.RandomState(2)
    n, h, k = 2, 32, 5
    imgs = [rs.rand(n, h, h, 3).astype(np.float32) for _ in range(4)]
    kps = [rs.uniform(-1.1, 1.1, (n, k, 3)).astype(np.float32) for _ in range(3)]
    occ = rs.rand(n, 8, 8, 1).astype(np.float32)
    for mask in (rs.rand(n, 8, 8, k + 1), rs.rand(n, 4, 8, 8, k + 1)):
        args = (imgs[0], imgs[1], imgs[2], imgs[3], *kps, occ, mask.astype(np.float32))
        ref = jax_logger.Visualizer().visualize(*args)
        out = logger.Visualizer().visualize(*args)
        assert out.dtype == ref.dtype == np.uint8 and np.array_equal(out, ref)
    cmap = matplotlib.pyplot.get_cmap("gist_rainbow")
    assert np.array_equal(logger._LUT, cmap(np.linspace(0, 1, 256)))
    for x in [i / 7 for i in range(8)] + [0.5, 0.999, 1.0]:
        assert logger.gist_rainbow(x) == cmap(x)
    path = logger.save_visualization(str(tmp_path / "vis"), 3, out)
    assert os.path.basename(path) == "00000003-rec.png"
    assert np.array_equal(imageio.imread(path), out)


ARGVS = [[], ["--tiny", "true"], ["--tiny", "true", "--image_size", "128", "--cpu_aug", "true"],
         ["--bf16", "true", "--remat", "false", "--ext", "_b", "--log_file", "run.log",
          "--batch_size", "4", "--lr", "1e-4", "--num_epochs", "3", "--num_repeats", "7",
          "--train_vae", "true", "--seed", "9", "--checkpoint_freq", "2",
          "--keep_checkpoints", "0", "--steps_per_call", "4", "--debug_nans", "true",
          "--profile_dir", "p", "--tensorboard", "true", "--pretrained_dir", "teach",
          "--num_workers", "3", "--ckp_dir", "c", "--vis_dir", "v", "--ckp", "-1"]]


def test_build_config_matches_the_root_cli():
    root = _root_train()
    for argv in ARGVS:
        argv = ["--root_dir", "data"] + argv
        ref, port = root.parse_args(argv), cli.parse_args(argv)
        for k, v in vars(ref).items():
            assert getattr(port, k) == v, (argv, k)
        assert set(vars(port)) == set(vars(ref)) | {"device"} and port.device == "cuda"
        assert (dataclasses.asdict(cli.build_config(port))
                == dataclasses.asdict(root.build_config(ref))), argv


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--device", "cpu", "--tiny", "true", "--batch_size", "2",
            "--num_repeats", "1", "--num_workers", "2", "--keep_checkpoints", "1",
            "--ckp_dir", f"{tmp}/ckp", "--vis_dir", f"{tmp}/vis", "--log_file",
            f"{tmp}/log.txt", *extra]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    return write_training_tree(root, 64, 2, 1, 3)


def test_cli_trains_and_resumes(tree, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)                       # --tensorboard writes ./runs
    state, records = cli.main(_argv(tree, tmp_path, "--num_epochs", "2"))
    assert state.step == 2 and state.epoch == 1
    assert [(r["epoch"], r["first_step"], r["frames"]) for r in records] == [(0, 0, 2), (1, 1, 2)]
    log = (tmp_path / "log.txt").read_text().splitlines()
    assert [ln[:10] for ln in log] == ["G00000000)", "D00000000)", "G00000001)", "D00000001)"]
    assert all("; K - nan; R - " in ln for ln in log[::2])
    assert sorted(os.listdir(tmp_path / "vis")) == ["00000000-rec.png", "00000001-rec.png"]
    assert os.listdir(tmp_path / "ckp") == ["00000001-checkpoint.msgpack"]
    out = capsys.readouterr().out
    assert "not ported" not in out and state.cfg.model.remat    # --remat true, the default
    assert "epoch 1: " in out and " frames/s (steps " in out

    state, records = cli.main(_argv(tree, tmp_path, "--num_epochs", "3", "--ckp", "-1",
                                    "--tensorboard", "true"))
    assert [(r["epoch"], r["first_step"]) for r in records] == [(2, 2)] and state.step == 3
    assert "resumed from epoch 1 (latest), continuing at 2 (step 2)" in capsys.readouterr().out
    assert os.listdir(tmp_path / "runs")
    assert os.listdir(tmp_path / "ckp") == ["00000002-checkpoint.msgpack"]

    # a JAX-written epoch file: --ckp 3 continues at epoch 4, step 5
    cfg = jax_tiny_config()
    _, variables = golden.train_variables(cfg, seed=5)
    jstate = golden.jax_train_state(cfg, variables).replace(
        epoch=jnp.asarray(3, jnp.int32), step=jnp.asarray(5, jnp.int32))
    jax_dir = tmp_path / "jax_ckp"
    jtrain.save_checkpoint(str(jax_dir), jstate, 3)
    state, records = cli.main(_argv(tree, tmp_path, "--num_epochs", "5", "--ckp", "3",
                                    "--ckp_dir", str(jax_dir)))
    assert [(r["epoch"], r["first_step"]) for r in records] == [(4, 5)] and state.step == 6
    back = jtrain.load_checkpoint(str(jax_dir), 4, jstate)
    assert int(back.step) == 6 and int(back.epoch) == 4


class _Loader:
    """A loader whose ``fail_at``-th batch raises ``error``."""

    def __init__(self, size, error, fail_at):
        self.size, self.error, self.fail_at = size, error, fail_at

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return 3

    def __iter__(self):
        rs = np.random.RandomState(0)
        for i in range(3):
            if i == self.fail_at:
                raise self.error
            yield tuple(rs.randint(0, 256, (2, self.size, self.size, 3)).astype(np.uint8)
                        for _ in range(2))


def test_a_loader_crash_saves_the_state(tmp_path):
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, ckp_dir=str(tmp_path / "ckp"), log_file=str(tmp_path / "log.txt"),
        vis_dir=str(tmp_path / "vis")))
    size = cfg.model.image_size
    state = create_train_state(cfg, "cpu")
    assert loop.train_loop(cfg, state, _Loader(size, KeyboardInterrupt(), 0)) == []
    assert checkpoint.list_checkpoints(cfg.train.ckp_dir)[0][0] == 0
    with pytest.raises(RuntimeError, match="loader broke"):
        loop.train_loop(cfg, state, _Loader(size, RuntimeError("loader broke"), 1))
    assert state.step == 1
    saved = checkpoint.load_checkpoint(cfg.train.ckp_dir, 0, create_train_state(cfg, "cpu"))
    assert saved.step == 1 and saved.epoch == 0
    for (k, a), b in zip(state.nets["afe"].state_dict().items(),
                         saved.nets["afe"].state_dict().values()):
        assert torch.equal(a, b), k


def test_cli_refuses_what_is_not_here(tree, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main(_argv(tree, tmp_path)[:2])
    for extra, match in ((["--steps_per_call", "2"], "requires --device_cache"),
                         (["--device_cache", "true", "--cpu_aug", "true"], "on-device aug")):
        with pytest.raises(SystemExit, match=match):
            cli.main(_argv(tree, tmp_path, *extra))
    # a machine of one card: two listed cards (or card 1) stop the run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for ids in ("0,1", "1"):
        with pytest.raises(SystemExit, match="this machine has 1 card"):
            cli.main(_argv(tree, tmp_path, "--gpu_ids", ids)[:2] + ["--gpu_ids", ids])
    assert not (tmp_path / "ckp").exists()


def test_prefetch_metric_buffer_and_profiler_on_the_cpu(tmp_path):
    batches = [(np.full((2, 3), i, np.uint8), np.full((2,), -i, np.float32)) for i in range(5)]
    got = list(loop._device_prefetch(batches, torch.device("cpu")))
    assert len(got) == 5 and all(isinstance(t, torch.Tensor) for b in got for t in b)
    assert all(np.array_equal(t.numpy(), b) for g, want in zip(got, batches)
               for t, b in zip(g, want))

    def broken():
        yield batches[0]
        raise ValueError("decode failed")

    it = loop._device_prefetch(broken(), torch.device("cpu"))
    next(it)
    with pytest.raises(ValueError, match="decode failed"):
        next(it)

    rs = np.random.RandomState(4)
    steps = [_losses(rs, True) for _ in range(19)]
    direct = logger.ScalarLog(str(tmp_path / "direct.txt"))
    buffered = logger.ScalarLog(str(tmp_path / "buffered.txt"))
    buf = loop._MetricBuffer(buffered)
    for i, (g, d) in enumerate(steps):
        direct.log_iter(g, d)
        buf.push({k: torch.tensor(v) for k, v in g.items()},
                 {k: torch.tensor(v) for k, v in d.items()})
        if i % 3 == 2:
            buf.flush()
    buf.drain()
    assert buf.last[0] == {k: float(np.float32(v)) for k, v in steps[-1][0].items()}
    buf.close()
    assert not buf._worker.is_alive()
    assert buffered.g_losses == [[float(np.float32(v)) for v in row] for row in direct.g_losses]
    assert buffered.g_names == direct.g_names and buffered.d_names == direct.d_names

    prof = loop._start_profiler(torch.device("cpu"))             # --profile_dir
    torch.ones(8).sum()
    loop._stop_profiler(prof, str(tmp_path / "trace"))
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
