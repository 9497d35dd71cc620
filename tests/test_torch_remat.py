"""PyTorch port: rematerialization (facevae_tpu_torch/remat.py, the
objective's remat boundaries) on the CPU, at tiny_config() and batch 2.

Two steps with ModelConfig.remat on are held to the same two steps with it
off, bit for bit: the losses of both phases, every trainable parameter's
gradient and value, BatchNorm running statistics, spectral u, v, and both
Adam states (step, exp_avg, exp_avg_sq); with train_vae (K > 0, the
driving EFE call's eps drawn from the step's generator: once, in the
forward), the step's every branch.  The warp forwards launch as often either way (their outputs are
kept, not recomputed), and the remat step runs each rematerialized net's
forward twice (the forward and its recompute) and the others once, at the
JAX objective's boundaries.  tests/test_torch_train.py holds the remat step
(tiny_config's default) to the JAX package's remat step, and
tests/test_torch_dp.py the 2-rank remat step to the 2-rank plain one.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from facevae_tpu_torch import remat
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.nn import BatchNorm, Conv, init_parameters
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
from torch_parity import one_torch_thread  # noqa: F401

STEPS = 2
# forward calls of each net in one step; with remat 2 for each call the JAX
# objective wraps in jax.checkpoint (the forward and its recompute), except
# the G phase's discriminator call on the real frame, whose outputs reach
# the losses only detached (F's real side): no backward, no recompute
PLAIN_CALLS = {"ckd": 1, "hpe_ede": 1, "efe": 3, "mfe": 1, "generator": 1,
               "discriminator": 4, "perceptual": 1, "afe": 1, "hopenet": 1, "contrastive": 1}
REMAT_CALLS = {"ckd": 2, "hpe_ede": 2, "efe": 6, "mfe": 2, "generator": 2,
               "discriminator": 7, "perceptual": 2, "afe": 1, "hopenet": 1, "contrastive": 1}


def _cfg(rm, train_vae):
    cfg = tiny_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=rm),
        train=dataclasses.replace(cfg.train, train_vae=train_vae),
        loss=dataclasses.replace(cfg.loss, kl=1.0 if train_vae else cfg.loss.kl))


@pytest.fixture(scope="module")
def seeded_nets():
    return build_all_modules(tiny_config(), "cpu")


def _run(nets, rm, train_vae):
    """STEPS steps from a copy of the seeded nets on one batch, TPS
    parameters and eps drawn from one generator: (state, outputs, launches,
    forward calls of each net in the first step)."""
    state = create_train_state(_cfg(rm, train_vae), "cpu", copy.deepcopy(nets))
    rs = np.random.RandomState(3)
    batch = tuple(torch.from_numpy(rs.rand(2, 64, 64, 3).astype(np.float32)) for _ in range(4))
    g = torch.Generator().manual_seed(5)
    calls = dict.fromkeys(state.nets, 0)
    hooks = [net.register_forward_pre_hook(
        lambda m, a, n=n: calls.__setitem__(n, calls[n] + 1)) for n, net in state.nets.items()]
    fast_warp.reset_launch_counts()
    outs = [train_step(state, batch, generator=g)]
    for h in hooks:
        h.remove()
    outs += [train_step(state, batch, generator=g) for _ in range(STEPS - 1)]
    return state, outs, dict(fast_warp.launches), calls


@pytest.fixture(scope="module")
def runs(seeded_nets):
    return _run(seeded_nets, False, True), _run(seeded_nets, True, True)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_remat_losses_and_gradients_are_the_plain_steps(runs):
    (plain, p_out, _, _), (rm, r_out, _, _) = runs
    assert rm.cfg.model.remat and not plain.cfg.model.remat
    for po, ro in zip(p_out, r_out):
        for phase in ("losses_g", "losses_d"):
            assert po[phase].keys() == ro[phase].keys()
            for k in po[phase]:
                assert _same(po[phase][k], ro[phase][k]), (phase, k)
    assert plain.cfg.train.train_vae and float(r_out[0]["losses_g"]["K"]) != 0.0
    n = 0
    for name, net in plain.nets.items():
        ours = dict(rm.nets[name].named_parameters())
        for k, p in net.named_parameters():
            q = ours[k]
            assert _same(p, q), f"{name}.{k}"
            assert (p.grad is None) == (q.grad is None), f"{name}.{k}"
            if p.grad is not None:
                assert _same(p.grad, q.grad), f"{name}.{k} grad"
                n += 1
    assert n > 100, n


def test_remat_buffers_and_adam_states_are_the_plain_steps(runs):
    (plain, *_), (rm, *_) = runs
    kinds = set()
    for name, net in plain.nets.items():
        ours = dict(rm.nets[name].named_buffers())
        for k, b in net.named_buffers():
            assert _same(b, ours[k]), f"{name}.{k}"
            kinds.add(k.rsplit(".", 1)[-1])
    assert {"running_mean", "running_var", "weight_u", "weight_v"} <= kinds
    for key in ("g_opt", "d_opt"):
        a, b = getattr(plain, key).state_dict()["state"], getattr(rm, key).state_dict()["state"]
        assert a.keys() == b.keys() and len(a) > 10
        for i in a:
            for k in ("step", "exp_avg", "exp_avg_sq"):
                assert _same(a[i][k], b[i][k]), (key, i, k)


def test_remat_launches_and_recomputes_at_the_jax_boundaries(runs):
    """The warp kernels' forward (here their plain versions, on the CPU)
    launches no more often with remat than without: the same counts, each
    half once a step per warp (MFE's multi-grid, the Generator's single-grid
    at fp32); each net's forward runs as REMAT_CALLS says."""
    (_, _, p_launch, p_calls), (_, _, r_launch, r_calls) = runs
    assert r_launch == p_launch
    assert r_launch["warp_fwd_plain"] == r_launch["grid_fwd_plain"] == STEPS
    assert p_calls == PLAIN_CALLS and r_calls == REMAT_CALLS


def test_remat_layers_recompute_without_advancing_their_state():
    """A spectral-norm Conv and a BatchNorm called twice in one graph, each
    call rematerialized: the same output, gradients and buffers as without
    remat (u, v and the running statistics advance once a call, and each
    recompute uses its own forward's u, v and batch statistics); outside a
    region remat.once calls through and remat.pin is the identity."""
    def nets():
        g = torch.Generator().manual_seed(0)
        conv = init_parameters(torch.nn.Sequential(Conv(4, 4, 3, 1, 1, spectral_norm=True)), g)
        return conv.train(), init_parameters(torch.nn.Sequential(BatchNorm(4)), g).train()

    x = torch.from_numpy(np.random.RandomState(1).randn(2, 4, 5, 5).astype(np.float32))
    results = []
    for rm in (False, True):
        conv, bn = nets()
        y = x
        for _ in range(2):
            y = remat.call(rm, lambda t: torch.tanh(bn(conv(t))), y)
        (y * y).sum().backward()
        results.append([y.detach(), conv[0].weight.grad, bn[0].weight.grad,
                        *conv.buffers(), *bn.buffers()])
    for a, b in zip(*results):
        assert _same(a, b)
    t = torch.ones(3)
    assert remat.once(lambda: t) is t and remat.pin(t, None) is t and not remat.replaying()
