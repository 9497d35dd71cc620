"""A tiny-config run of each driver kind on the CPU through the port's
plain path, with the plain reference agreeing, and the same runs with the
timed path broken underneath, where `correct` has to come out false (the
look for cards is skipped: run.run_cell is a run from there on)."""
from __future__ import annotations

import torch

from portbench import run as runmod
from portbench.tests import tiny

SEED = 2 ** 31 + 12345


def _train(plant=None, trace=False):
    return runmod.run_cell("train-fp32", SEED, 0.2, trace, torch.device("cpu"),
                           cell=tiny.tiny_train_cell(), config=tiny.tiny_config(), plant=plant)


def _serve(plant=None, trace=False):
    return runmod.run_cell("serve-fp32-c16", SEED, 2.0, trace, torch.device("cpu"),
                           cell=tiny.tiny_serve_cell(), config=tiny.tiny_config(), plant=plant)


def test_train_agrees_with_the_reference_and_reads_layers():
    line, res = _train(trace=True)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    n = res["numbers"]
    # tiny nets, batch 2: BatchNorm over two rows amplifies round-off
    assert n["first_loss_gap"] < 1e-3 and n["first_grad_gap"] < 0.05, n
    assert n["change_gap_median"] < 0.1 and n["first_buffer_gap"] < 0.05, n
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert "mfu.train" in line["metrics"] and line["metrics"]["mfu.train"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def unchanged(step):
    """A step that returns its state unchanged."""
    def broken(state, batch, **kw):
        nets = state.nets.values()
        kept = [t.detach().clone() for m in nets for t in list(m.parameters()) + list(m.buffers())]
        out = step(state, batch, **kw)
        with torch.no_grad():
            for t, k in zip([t for m in nets for t in list(m.parameters()) + list(m.buffers())],
                            kept):
                t.copy_(k)
        state.g_opt.state.clear()
        state.d_opt.state.clear()
        return out
    return broken


def half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def broken(state, batch, **kw):
        return step(state, tuple(x[: x.shape[0] // 2] for x in batch), **kw)
    return broken


def altered(drive_frame):
    """Every answer altered where it is produced: each frame mirrored."""
    def broken(*args):
        return drive_frame(*args).flip(2)
    return broken


def test_train_state_unchanged_is_not_correct():
    line, res = _train(plant=unchanged)
    assert res["numbers"]["change_gap_median"] > 0.9 and line["correct"] is False


def test_train_half_batch_is_not_correct():
    line, res = _train(plant=half_batch)
    assert res["numbers"]["first_loss_gap"] > 1e-2 and line["correct"] is False


def test_serve_agrees_with_the_reference():
    line, res = _serve(trace=True)
    n = res["numbers"]
    assert n["frame_gap"] < 1e-4 and n["byte_mismatch"] < 1e-3, n
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"batch_fill.serve", "flush_ms.serve"} <= set(line["metrics"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_serve_answer_altered_is_not_correct():
    line, res = _serve(plant=altered)
    assert res["numbers"]["frame_gap"] > 1e-3 and line["correct"] is False
