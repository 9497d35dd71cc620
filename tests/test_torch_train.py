"""PyTorch port: the training slice against facevae_tpu's, at tiny_config()
and batch 2 on the CPU (the warp's plain versions stand in for its kernels).

Both packages start from one JAX train state (every tree filled from a numpy
seed, tools/make_torch_golden.py:train_variables) that convert.py carries
into the port, and see the same numpy images and TPS parameters.

In training mode this model is ill-conditioned at fp32: BatchNorm
normalizes by statistics of a few samples in its last blocks (of two in the
contrastive head), and the 0.1-temperature soft-argmax heads amplify
rounding.  So the JAX package runs three times: on the images, on the
images nudged by 2^-20 relative (a few fp32 ulps), and in its float64 mode
(jax.enable_x64; its convolutions stay fp32, the rest runs in float64).
The largest distance of the last two answers from the first is the
reference's own rounding spread (measured on the G-phase losses: up to
~5e-5 relative, on some gradient leaves ~10%).  The port is held to the
first answer within 10x that spread (torch_parity.assert_held), plus
- 1e-4 of |ref| for the losses of the G and D phases;
- 1e-3 of max|ref| for the gradient of every G and D parameter, where the
  scale of a leaf is at least 1e-2 of its net's largest gradient (a bias
  that feeds a training-mode norm or a softmax over space has gradient 0 in
  exact arithmetic, and both packages return rounding noise there);
- 1e-4 of max|ref| for BatchNorm running statistics and spectral u, v
  after the step;
- for the losses of three steps of the JAX package's own jitted step, 1e-4
  of |ref| at step 1 and 1e-2 at steps 2 and 3: Adam's first updates are
  sign-like (lr * g / |g|), so on every leaf whose gradient is rounding
  noise the two packages step by +-lr in directions that differ (measured:
  0.6% on the feature-matching loss F at step 3).
A wrong term or layout misses by orders of magnitude more on the
well-conditioned outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu.ops.tps import TransformParams as JaxTransformParams
from facevae_tpu.train.step import make_train_step
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_train_state, state_dict_from_jax
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train import (LOSS_NAMES, build_all_modules, create_train_state,
                                     generator_forward, train_step)
from torch_parity import assert_held, golden, one_torch_thread  # noqa: F401

LOSS_REL = 1e-4
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-2
STATE_REL = 1e-4
LATER_LOSS_REL = 1e-2


NUDGE = 2.0 ** -20


def _jax_refs(env, fn):
    """fn(state, batch, tp) on the images, on the nudged images and in
    float64 mode -> (ref, [ref_nudged, ref_x64]), numpy."""
    def run(batch, dtype):
        cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
        state = golden.jax_train_state(env["cfg"], jax.tree.map(cast, env["variables"]))
        tp = JaxTransformParams(*map(cast, env["tp"]))
        return jax.tree.map(np.asarray, fn(state, tuple(map(cast, batch)), tp))

    rs = np.random.RandomState(9)
    nudged = tuple(b * (1 + NUDGE * rs.randn(*b.shape)).astype(np.float32)
                   for b in env["batch"])
    ref, ref_nudged = run(env["batch"], np.float32), run(nudged, np.float32)
    with jax.enable_x64(True):
        ref_x64 = run(env["batch"], np.float64)
    return ref, [ref_nudged, ref_x64]


@pytest.fixture(scope="module")
def env():
    cfg = jax_tiny_config()
    models, variables = golden.train_variables(cfg, seed=21)
    rs = np.random.RandomState(5)
    N, size = 2, cfg.model.image_size
    batch = tuple(rs.rand(N, size, size, 3).astype(np.float32) for _ in range(4))
    tp = (np.eye(2, 3, dtype=np.float32)[None] + 0.05 * rs.randn(N, 2, 3).astype(np.float32),
          np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2),
          (0.005 * rs.randn(N, 1, 25)).astype(np.float32))
    env = dict(cfg=cfg, models=models, variables=variables, batch=batch, tp=tp,
               tree=golden.train_state_tree(golden.jax_train_state(cfg, variables)))
    env["refs"] = _jax_refs(env, lambda state, b, t: golden.jax_step_grads(
        cfg, models, state, b, jax.random.PRNGKey(0), t))
    return env


def _port_state(env):
    cfg = tiny_config()
    nets = build_all_modules(cfg, "cpu")
    load_jax_train_state(nets, env["tree"])
    return create_train_state(cfg, "cpu", nets)


def _port_inputs(env):
    return (tuple(torch.from_numpy(a.copy()) for a in env["batch"]),
            TransformParams(*(torch.from_numpy(a.copy()) for a in env["tp"])))


def _pick(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _refs(env, *path):
    """(ref, [others]) at ``path`` of the JAX answers."""
    ref, others = env["refs"]
    return _pick(ref, path), [_pick(o, path) for o in others]


def test_train_state_bridge_is_strict(env):
    """convert.load_jax_train_state fills every net, teachers included, and
    refuses a state that lacks a tree, has a tree with no net, or leaves a
    net unfilled."""
    nets = build_all_modules(tiny_config(), "cpu")
    missing = {k: v for k, v in env["tree"].items() if k != "teachers"}
    extra = {**env["tree"], "c_params": {**env["tree"]["c_params"], "ghost": {}}}
    partial = {**env["tree"], "teachers": {"hopenet": env["tree"]["teachers"]["hopenet"]}}
    for tree, match in ((missing, "lacks"), (extra, "lacks"), (partial, "no state")):
        with pytest.raises(ValueError, match=match):
            load_jax_train_state(nets, tree)
    load_jax_train_state(nets, env["tree"])
    ref = state_dict_from_jax(env["variables"]["hopenet"])
    for k, v in nets["hopenet"].state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k])


def test_generator_forward_losses(env):
    state = _port_state(env)
    batch, tp = _port_inputs(env)
    with torch.no_grad():
        losses, aux = generator_forward(state.nets, state.cfg, *batch, transform_params=tp)
    assert tuple(losses) == LOSS_NAMES
    for k in LOSS_NAMES:
        assert_held(losses[k], *_refs(env, "losses_g", k), LOSS_REL, f"loss {k}")
    assert aux["generated_d"].shape == batch[1].shape


@pytest.fixture(scope="module")
def stepped(env):
    """The port's state after one step, and that step's outputs."""
    state = _port_state(env)
    batch, tp = _port_inputs(env)
    fast_warp.reset_launch_counts()
    out = train_step(state, batch, transform_params=tp)
    return state, out, dict(fast_warp.launches)


def test_step_losses_and_plain_launches(env, stepped):
    _, out, launches = stepped
    for k in LOSS_NAMES:
        assert_held(out["losses_g"][k], *_refs(env, "losses_g", k), LOSS_REL, f"loss {k}")
    for k in ("G1", "G2"):
        assert_held(out["losses_d"][k], *_refs(env, "losses_d", k), LOSS_REL, f"loss {k}")
    # one forward and one backward of each half per step: MFE's multi-grid
    # warp and the Generator's single-grid warp (fp32)
    assert launches == {"warp_fwd": 0, "warp_fwd_plain": 1, "warp_bwd_dgrid": 0,
                        "warp_bwd_dgrid_plain": 1, "warp_bwd_dx": 0, "warp_bwd_dx_plain": 1,
                        "warp_bwd_dx_det": 0, "grid_fwd": 0, "grid_fwd_plain": 1,
                        "grid_bwd_dgrid": 0, "grid_bwd_dgrid_plain": 1, "grid_bwd_dx": 0,
                        "grid_bwd_dx_plain": 1, "grid_bwd_dx_det": 0}


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES)
def test_step_gradients(env, stepped, name):
    state, _, _ = stepped
    col = "d_grads" if name in D_MODEL_NAMES else "g_grads"
    r, others = _refs(env, col, name)
    ref = state_dict_from_jax({"params": r})
    others = [state_dict_from_jax({"params": o}) for o in others]
    port = dict(state.nets[name].named_parameters())
    assert set(ref) == set(port)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for key, r in ref.items():
        assert port[key].grad is not None, f"{name}.{key} has no gradient"
        assert_held(port[key].grad, r, [o[key] for o in others], GRAD_REL, f"{name}.{key} grad",
                    scale=max(float(np.abs(r).max()), GRAD_FLOOR * top))


def test_contrastive_head_is_not_stepped(env, stepped):
    """Quirk q7: no gradient, no update for the head's parameters; its BN
    statistics train (checked with the other buffers below)."""
    state, _, _ = stepped
    ref = state_dict_from_jax({"params": env["variables"]["contrastive"]["params"]})
    for key, p in state.nets["contrastive"].named_parameters():
        assert p.grad is None
        np.testing.assert_array_equal(p.detach().numpy(), ref[key])


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES + ("contrastive",))
def test_step_buffers(env, stepped, name):
    """BN running statistics and spectral u, v after the G and D phases."""
    state, _, _ = stepped
    refs = []
    for tree in [env["refs"][0]] + env["refs"][1]:
        cols = {c: tree[c][name] for c in ("batch_stats", "spectral") if name in tree[c]}
        assert cols, f"{name} has no BN or spectral state"
        refs.append(state_dict_from_jax({"params": env["variables"][name]["params"], **cols}))
    bufs = dict(state.nets[name].named_buffers())
    keys = [k for k in refs[0]
            if k.endswith(("running_mean", "running_var", "weight_u", "weight_v"))]
    assert keys and set(keys) == set(bufs)
    for k in keys:
        assert_held(bufs[k], refs[0][k], [r[k] for r in refs[1:]], STATE_REL, f"{name}.{k}")


def test_three_steps_against_the_jax_step(env):
    """The JAX package's jitted step and the port's, three steps from one
    state on one batch: the losses of every step.  (Adam's first updates
    are sign-like, lr * g / |g|, so the losses, not raw parameters where a
    gradient is near 0, are the comparison.)"""
    _, jstep = make_train_step(env["cfg"], models=env["models"], donate=False)

    def jax_losses(jstate, batch, tp):
        out = []
        for i in range(3):
            jstate, m = jstep(jstate, batch, jax.random.PRNGKey(i), tp)
            out.append({**m["losses_g"], **m["losses_d"]})
        return out

    ref, others = _jax_refs(env, jax_losses)
    state = _port_state(env)
    batch, tp = _port_inputs(env)
    for i in range(3):
        out = train_step(state, batch, transform_params=tp)
        port = {**out["losses_g"], **out["losses_d"]}
        assert set(port) == set(ref[i])
        for k, v in port.items():
            assert_held(v, ref[i][k], [o[i][k] for o in others],
                        LOSS_REL if i == 0 else LATER_LOSS_REL, f"step {i + 1} loss {k}")
    assert state.step == 3
