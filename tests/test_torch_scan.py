"""PyTorch port: the multi-step dispatcher (train/scan.py) and the training
CLI's new modes, on the CPU at tiny_config.

- ScanStep: one call of K = 3 steps over a frame tensor and [3, 2] index
  tables equals three steps of the loop's own (a reseed with
  train/step.py:step_seed, then train_step with the fused augmentation on
  the gathered frames), bit for bit: every step's losses, the last step's
  aux, and the state after (every parameter and buffer, both Adam states,
  the step count).  On the CPU the dispatcher runs its body eagerly; on
  the card it replays a CUDA graph of it (chip_smoke.py phase scan).  A
  capturable Adam (the card's) reads that state's epoch tree with its step
  count as an fp32 tensor beside the parameters.
- python -m facevae_tpu_torch.train with --device_cache true: K = 2
  (--steps_per_call 2: a call of 2 steps and the remainder call of 1 per
  3-step epoch) writes the log K = 1 writes, byte for byte; the epoch
  files hold the same state.
- --device cpu --gpu_ids 0,1 (two gloo processes): one log, one epoch file,
  one visualization, all from rank 0.
- The capture-safe forms the step now takes (a CUDA graph's capture forbids
  a host sync and a copy from the host): torch.linalg.inv_ex in
  ops/geometry.py and ops/motion.py gives inv's bits; numerics.constant
  gives torch.tensor's values, made once per (values, dtype, device).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from facevae_tpu_torch import numerics
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.ops import geometry, motion
from facevae_tpu_torch.data.synthetic import write_training_tree
from facevae_tpu_torch.train import cli, create_train_state, train_step
from facevae_tpu_torch.convert import load_jax_train_state
from facevae_tpu_torch.train import checkpoint
from facevae_tpu_torch.train.checkpoint import read_checkpoint
from facevae_tpu_torch.train.scan import ScanStep
from facevae_tpu_torch.train.step import step_seed
from torch_parity import one_torch_thread  # noqa: F401

SEED = 3


def _state_bits(state):
    out = {f"{n}.{k}": v.clone() for n, net in state.nets.items()
           for k, v in net.state_dict().items()}
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
            for k, v in opt.state[p].items():
                out[f"{name}[{i}].{k}"] = v.clone()
    return out


def test_scan_equals_the_loop_steps_bit_for_bit():
    cfg = tiny_config()
    # the dispatcher against the loop, not remat (tests/test_torch_remat.py)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=False))
    rs = np.random.RandomState(0)
    size = cfg.model.image_size
    frames = torch.from_numpy(rs.randint(0, 256, (6, size, size, 3)).astype(np.uint8))
    s_idx, d_idx = rs.randint(0, 6, (3, 2)), rs.randint(0, 6, (3, 2))
    seed_of = lambda step: step_seed(SEED, step)  # noqa: E731

    a = create_train_state(cfg, "cpu")
    scan = ScanStep(a, frames, torch.Generator(), seed_of)
    got = scan(s_idx, d_idx)
    assert a.step == 3 and scan.eager_steps == 3 and scan.graph is None

    b = create_train_state(cfg, "cpu")
    gen = torch.Generator()
    for k in range(3):
        gen.manual_seed(seed_of(b.step))
        s, d = (frames[torch.from_numpy(i[k])] for i in (s_idx, d_idx))
        out = train_step(b, (s, d), generator=gen, fused_aug=True)
        for group in ("losses_g", "losses_d"):
            assert list(got[group]) == list(out[group])
            for n, v in out[group].items():
                assert got[group][n].shape == (3,)
                assert torch.equal(got[group][n][k], v.float()), (k, n)
    for n, v in out["aux"].items():
        assert torch.equal(got["aux"][n], v), n
    bits_a, bits_b = _state_bits(a), _state_bits(b)
    assert list(bits_a) == list(bits_b)
    for k, v in bits_a.items():
        assert torch.equal(v, bits_b[k]), k

    # a capturable Adam (the card's) reads the epoch file's Adam state with
    # its step count as an fp32 tensor where the parameters lie
    c = create_train_state(cfg, "cpu")
    for name in ("g_opt", "d_opt"):
        opt = getattr(c, name)
        setattr(c, name, torch.optim.Adam(opt.param_groups[0]["params"], capturable=True,
                                          **{k: opt.defaults[k] for k in ("lr", "betas", "eps")}))
    load_jax_train_state(c.nets, checkpoint._jax_tree(checkpoint._tensors(a)),
                         {"g_opt": c.g_opt, "d_opt": c.d_opt})
    for name in ("g_opt", "d_opt"):
        for p, q in zip(getattr(a, name).param_groups[0]["params"],
                        getattr(c, name).param_groups[0]["params"]):
            st = getattr(c, name).state[q]
            assert st["step"].dtype == torch.float32 and st["step"].device == q.device
            assert float(st["step"]) == 3 and torch.equal(st["exp_avg"],
                                                          getattr(a, name).state[p]["exp_avg"])


def test_capture_safe_forms_keep_the_bits(monkeypatch):
    rs = np.random.RandomState(1)
    t = lambda *shape: torch.from_numpy(rs.randn(*shape).astype(np.float32))  # noqa: E731
    kp, angles, tr, delta = t(2, 5, 3), [t(2) for _ in range(6)], t(2, 3), t(2, 5, 3)
    fs = torch.zeros(2, 4, 6, 6, 1)
    Rs, Rd = geometry.pose_rotation(*angles[:3]), geometry.pose_rotation(*angles[3:])

    def outputs():
        return (geometry.transform_kp_with_new_pose(kp, *angles[:3], tr, delta, *angles[3:]),
                motion.create_sparse_motions(fs, kp, kp + 0.1, Rs, Rd),
                motion.motion_affine_params(kp, kp + 0.1, Rs, Rd))

    new = outputs()
    monkeypatch.setattr(torch.linalg, "inv_ex", lambda a: (torch.linalg.inv(a), None))
    old = outputs()
    def flat(o):
        return [x for v in o for x in (flat(v) if isinstance(v, tuple) else [v])]

    assert all(torch.equal(a, b) for a, b in zip(flat(new), flat(old), strict=True))
    for values, dtype in (((0.299, 0.587, 0.114), torch.float32),
                          (((1.0, 0.0, -3.5), (0.0, 1.0, 2.0)), torch.bfloat16)):
        c = numerics.constant(values, dtype, "cpu")
        assert torch.equal(c, torch.tensor(values, dtype=dtype)) and c.dtype == dtype
        assert numerics.constant(values, dtype, "cpu") is c


def _argv(root, tmp, *extra):
    return ["--root_dir", root, "--device", "cpu", "--tiny", "true", "--image_size", "64",
            "--num_workers", "1", "--keep_checkpoints", "1", "--ckp_dir", f"{tmp}/ckp",
            "--vis_dir", f"{tmp}/vis", "--log_file", f"{tmp}/log.txt", *extra]


def test_cli_steps_per_call_writes_the_log_of_single_steps(tmp_path):
    tree = write_training_tree(str(tmp_path / "tree"), 64, 2, 1, 3)
    runs = {}
    for k in (1, 2):
        tmp = tmp_path / f"k{k}"
        state, records = cli.main(_argv(tree, tmp, "--batch_size", "2", "--num_repeats", "3",
                                        "--num_epochs", "1", "--device_cache", "true",
                                        "--steps_per_call", str(k)))
        assert state.step == 3 and [r["first_step"] for r in records] == [0]
        runs[k] = (tmp / "log.txt").read_bytes(), read_checkpoint(str(tmp / "ckp"), 0), records
    assert runs[1][0] == runs[2][0] and runs[1][0].count(b"\n") == 2
    assert runs[2][2][-1]["scan"]["eager_steps"] == 3          # the CPU runs eagerly
    flat = lambda t, p="": ([(p, t)] if not isinstance(t, dict)  # noqa: E731
                            else [x for k, v in t.items() for x in flat(v, f"{p}/{k}")])
    a, b = flat(runs[1][1]), flat(runs[2][1])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), p
    with pytest.raises(SystemExit, match="requires --device_cache"):
        cli.main(_argv(tree, tmp_path / "bad", "--steps_per_call", "2"))


def test_cli_two_gloo_ranks_write_from_rank_0_only(tmp_path):
    tree = write_training_tree(str(tmp_path / "tree"), 64, 2, 1, 3)
    argv = ["--root_dir", tree, "--device", "cpu", "--tiny", "true", "--image_size", "64",
            "--batch_size", "1", "--num_repeats", "1", "--num_workers", "1",
            "--gpu_ids", "0,1", "--num_epochs", "1", "--ckp_dir", f"{tmp_path}/ckp",
            "--vis_dir", f"{tmp_path}/vis", "--log_file", f"{tmp_path}/log.txt"]
    state, records = cli.main(argv)
    assert state is None and [(r["epoch"], r["frames"]) for r in records] == [(0, 2)]
    assert os.listdir(tmp_path / "ckp") == ["00000000-checkpoint.msgpack"]
    assert os.listdir(tmp_path / "vis") == ["00000000-rec.png"]
    log = (tmp_path / "log.txt").read_text().splitlines()
    assert [ln[:10] for ln in log] == ["G00000000)", "D00000000)"]
    assert sorted(os.listdir(tmp_path)) == ["ckp", "log.txt", "tree", "vis"]
