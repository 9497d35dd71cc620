"""PyTorch port: a training step with VAE sampling (TrainConfig.train_vae,
LossConfig.kl = 1) against facevae_tpu's, at tiny_config() and batch 2 on
the CPU.

Both packages start from one JAX train state (numpy-seeded,
tools/make_torch_golden.py:train_variables) and see the same images, TPS
parameters and VAE noise: JAX's threefry draw cannot be reproduced in
torch, so jax.random.normal as facevae_tpu.models.vae sees it is patched to
return the eps the port is given (train_step's vae_eps).  Only the driving
frame's EFE call samples; K is the weighted KL term of its mu / logstd.

Held as tests/test_torch_train.py holds the default step
(torch_parity.assert_held: within 10x the JAX step's own change under
inputs nudged by 2^-20 relative, which reuses the fp32 compilation, and in
its float64 mode), plus 1e-4 of
|ref| for every loss (K included) and 1e-3 of the scale for the gradient of
every G and D parameter, a leaf's scale at least 1e-2 of its net's largest.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.models import vae as jax_vae
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu.ops.tps import TransformParams as JaxTransformParams
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_train_state, state_dict_from_jax
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train import LOSS_NAMES, build_all_modules, create_train_state, train_step
from torch_parity import assert_held, fixed_normal, golden, one_torch_thread  # noqa: F401

LOSS_REL, GRAD_REL, GRAD_FLOOR = 1e-4, 1e-3, 1e-2
NUDGE = 2.0 ** -20


def _vae_cfg(cfg):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, train_vae=True),
                               loss=dataclasses.replace(cfg.loss, kl=1.0))


@pytest.fixture(scope="module")
def env():
    cfg = _vae_cfg(jax_tiny_config())
    models, variables = golden.train_variables(cfg, seed=23)
    rs = np.random.RandomState(6)
    N, size = 2, cfg.model.image_size
    batch = tuple(rs.rand(N, size, size, 3).astype(np.float32) for _ in range(4))
    tp = (np.eye(2, 3, dtype=np.float32)[None] + 0.05 * rs.randn(N, 2, 3).astype(np.float32),
          np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2),
          (0.005 * rs.randn(N, 1, 25)).astype(np.float32))
    # the EFE bottleneck of tiny_config is 1x1 with Cz = 16: eps [N, 16]
    eps = rs.randn(N, cfg.model.efe_down_seq[-1] // 2).astype(np.float32)
    nudged = tuple(b * (1 + NUDGE * rs.randn(*b.shape)).astype(np.float32) for b in batch)

    step_grads = golden.make_step_grads(cfg, models, train_vae=True)

    def run(images, dtype):
        cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
        state = golden.jax_train_state(cfg, jax.tree.map(cast, variables))
        return step_grads(state, tuple(map(cast, images)), jax.random.PRNGKey(0),
                          JaxTransformParams(*map(cast, tp)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vae, "jax", fixed_normal(eps))
        ref, ref_nudged = run(batch, np.float32), run(nudged, np.float32)
        with jax.enable_x64(True):
            ref_x64 = run(batch, np.float64)
    return dict(batch=batch, tp=tp, eps=eps, refs=(ref, [ref_nudged, ref_x64]),
                tree=golden.train_state_tree(golden.jax_train_state(cfg, variables)))


@pytest.fixture(scope="module")
def stepped(env):
    cfg = _vae_cfg(tiny_config())
    nets = build_all_modules(cfg, "cpu")
    load_jax_train_state(nets, env["tree"])
    state = create_train_state(cfg, "cpu", nets)
    fast_warp.reset_launch_counts()
    out = train_step(state, tuple(torch.from_numpy(a.copy()) for a in env["batch"]),
                     transform_params=TransformParams(*(torch.from_numpy(a.copy())
                                                        for a in env["tp"])),
                     vae_eps=torch.from_numpy(env["eps"]))
    return state, out, dict(fast_warp.launches)


def _refs(env, *path):
    """(ref, [others]) at ``path`` of the JAX answers."""
    def pick(tree):
        for p in path:
            tree = tree[p]
        return tree
    ref, others = env["refs"]
    return pick(ref), [pick(o) for o in others]


def test_vae_step_losses(env, stepped):
    """Every loss of both phases; K is nonzero and is the KL term."""
    _, out, launches = stepped
    assert tuple(out["losses_g"]) == LOSS_NAMES
    for k in LOSS_NAMES:
        assert_held(out["losses_g"][k], *_refs(env, "losses_g", k), LOSS_REL, f"loss {k}")
    for k in ("G1", "G2"):
        assert_held(out["losses_d"][k], *_refs(env, "losses_d", k), LOSS_REL, f"loss {k}")
    assert float(out["losses_g"]["K"]) > 0.0
    # the same warps as the default fp32 step, by their plain versions
    assert {k: v for k, v in launches.items() if v} == {
        "warp_fwd_plain": 1, "warp_bwd_dgrid_plain": 1, "warp_bwd_dx_plain": 1,
        "grid_fwd_plain": 1, "grid_bwd_dgrid_plain": 1, "grid_bwd_dx_plain": 1}


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES)
def test_vae_step_gradients(env, stepped, name):
    state, _, _ = stepped
    col = "d_grads" if name in D_MODEL_NAMES else "g_grads"
    r, others = _refs(env, col, name)
    ref = state_dict_from_jax({"params": r})
    others = [state_dict_from_jax({"params": o}) for o in others]
    port = dict(state.nets[name].named_parameters())
    assert set(ref) == set(port)
    top = max(float(np.abs(v).max()) for v in ref.values())
    for key, v in ref.items():
        assert port[key].grad is not None, f"{name}.{key} has no gradient"
        assert_held(port[key].grad, v, [o[key] for o in others], GRAD_REL, f"{name}.{key} grad",
                    scale=max(float(np.abs(v).max()), GRAD_FLOOR * top))


def test_vae_eps_is_drawn_after_the_tps_parameters():
    """Without vae_eps the step draws eps from its generator after the TPS
    parameters (the JAX objective's key split: TPS first, then noise): a
    forward with the eps drawn that way by hand gives the same losses."""
    from facevae_tpu_torch.ops.tps import random_transform_params
    from facevae_tpu_torch.train import generator_forward
    cfg = _vae_cfg(tiny_config())
    g = torch.Generator().manual_seed(3)
    size = cfg.model.image_size
    batch = tuple(torch.rand(2, size, size, 3, generator=g) for _ in range(4))
    t = cfg.train
    with torch.no_grad():
        # fresh nets for each call: a training-mode forward advances spectral u, v
        drawn, _ = generator_forward(build_all_modules(cfg, "cpu"), cfg, *batch,
                                     generator=torch.Generator().manual_seed(7), train_vae=True)
        g = torch.Generator().manual_seed(7)
        tp = random_transform_params(g, 2, sigma_affine=t.sigma_affine, sigma_tps=t.sigma_tps,
                                     points_tps=t.points_tps)
        eps = torch.randn(2, cfg.model.efe_down_seq[-1] // 2, generator=g)
        given, _ = generator_forward(build_all_modules(cfg, "cpu"), cfg, *batch,
                                     transform_params=tp, train_vae=True, vae_eps=eps)
    for k in LOSS_NAMES:
        assert torch.equal(drawn[k], given[k]), k
    assert float(given["K"]) > 0.0
