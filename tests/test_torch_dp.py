"""PyTorch port: data parallelism (parallel/, BatchNorm's group, the step's
all-reduces) on the CPU, in gloo processes, at tiny_config.

- Against the JAX package: JAX's data-parallel step (make_train_step with
  make_mesh(2), its transform_params variant) on a global batch of 2, and
  the port's step in 2 gloo ranks, each given its half of the images and
  of the TPS parameters, from the same numpy weights (train_variables).
  Held with tests/torch_parity.py:assert_held, as tests/test_torch_train.py
  holds the one-device step, JAX's own spread taken from its step on images
  nudged by 2^-20 relative: the ranks' mean losses (1e-4 of |ref|); BN
  running statistics and spectral u, v after the step (1e-4 of max|ref|);
  each trained parameter's Adam first moment, (1 - b1) times the gradient
  the step applied, the ranks' mean (1e-3 of max|ref|, a leaf's scale at
  least 1e-2 of its net's largest); the updated parameters, within 1e-6 of
  max|ref| where the applied gradient's sign is settled (|g| above the
  gradient's own limit: Adam's first update is lr * g / (|g| + eps), so a
  gradient of rounding noise moves its parameter by +-lr either way), and
  everywhere within 2 lr.
- Within the port: 2 ranks against one process on the concatenated batch,
  two steps, F rescaled by the ranks (F is each rank's own batch's), held
  as the JAX package holds its 8-device step to 1 device
  (tests/test_train_step.py:test_dp_vs_1dev_multistep): losses within 1e-2
  of max(1, |ref|) at step 1 and 25x that at step 2, parameters within
  1e-3 x the step.  A group of one rank equals no group, bit for bit.
- Remat: the ranks above run tiny_config(), which rematerializes (as the
  JAX step's does); a second pair of ranks runs the first step without
  remat, and both ranks' losses and snapshot after it (parameters,
  buffers, gradients, Adam moments) are the same bits.
- The sharded frame cache: sample_indices and iter_index_chunks equal the
  JAX cache's with make_mesh(2), index for index; each rank holds its
  identities' frames.

The spawned ranks run facevae_tpu_torch/parallel/dp_check.py (children
import nothing of the test tree, so no JAX); rank 1 also runs the
one-process reference, rank 0 the one-rank group, while JAX compiles in
the test's process.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.data import device_cache as jax_cache
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu.ops.tps import TransformParams as JaxTransformParams
from facevae_tpu.parallel import make_mesh
from facevae_tpu.train.step import make_train_step
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import state_dict_from_jax
from facevae_tpu_torch.data import device_cache
from facevae_tpu_torch.data.synthetic import write_training_tree
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.parallel import dp_check
from facevae_tpu_torch.parallel.spawn import start
from torch_parity import assert_held, golden, one_torch_thread  # noqa: F401

LOSS_REL, STATE_REL, GRAD_REL, GRAD_FLOOR, PARAM_REL = 1e-4, 1e-4, 1e-3, 1e-2, 1e-6
NUDGE = 2.0 ** -20
WORLD = 2
B1 = 0.5                       # TrainConfig.adam_b1


def _images(rs, n, size):
    return tuple(rs.rand(n, size, size, 3).astype(np.float32) for _ in range(4))


def _tp(rs, n):
    return (np.eye(2, 3, dtype=np.float32)[None] + 0.05 * rs.randn(n, 2, 3).astype(np.float32),
            np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2),
            (0.005 * rs.randn(n, 1, 25)).astype(np.float32))


def _state_tree(variables):
    """The train-state tree golden.jax_train_state lays out over
    ``variables`` (what convert.load_jax_train_state reads), as numpy."""
    def col(names, c):
        return {m: jax.tree.map(np.asarray, variables[m][c]) for m in names
                if c in variables[m]}

    trained = G_MODEL_NAMES + D_MODEL_NAMES + ("contrastive",)
    return {"g_params": col(G_MODEL_NAMES, "params"), "d_params": col(D_MODEL_NAMES, "params"),
            "c_params": col(("contrastive",), "params"),
            "teachers": {m: jax.tree.map(np.asarray, variables[m])
                         for m in ("hopenet", "perceptual")},
            "batch_stats": col(trained, "batch_stats"), "spectral": col(trained, "spectral")}


def _jax_side(cfg, variables, batch, tp):
    """JAX's 2-device step on ``batch`` and on it nudged: each the new
    state's (losses, {net: state dict of params, batch stats, spectral},
    {net: applied gradient by key}), numpy, in the port's names."""
    _, step = make_train_step(cfg, mesh=make_mesh(WORLD), donate=False)
    rs = np.random.RandomState(9)
    nudged = tuple(b * (1 + NUDGE * rs.randn(*b.shape)).astype(np.float32) for b in batch)
    out = []
    for images in (batch, nudged):
        state = golden.jax_train_state(cfg, variables)
        new, m = step(state, tuple(map(jnp.asarray, images)), jax.random.PRNGKey(0),
                      JaxTransformParams(*map(jnp.asarray, tp)))
        new = jax.tree.map(np.asarray, new)
        losses = {k: float(v) for k, v in {**m["losses_g"], **m["losses_d"]}.items()}
        nets, grads = {}, {}
        for n in G_MODEL_NAMES + D_MODEL_NAMES + ("contrastive",):
            params = {**new.g_params, **new.d_params, **new.c_params}[n]
            cols = {c: getattr(new, c)[n] for c in ("batch_stats", "spectral")
                    if n in getattr(new, c)}
            nets[n] = state_dict_from_jax({"params": params, **cols})
        for opt, names in ((new.g_opt, G_MODEL_NAMES), (new.d_opt, D_MODEL_NAMES)):
            for n in names:
                grads[n] = {k: v / (1 - B1)
                            for k, v in state_dict_from_jax({"params": opt[0].mu[n]}).items()}
        out.append((losses, nets, grads))
    return out


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cfg = jax_tiny_config()
    _, variables = golden.train_variables(cfg, seed=21)
    rs = np.random.RandomState(5)
    size = cfg.model.image_size
    steps = [(_images(rs, WORLD, size), _tp(rs, WORLD)) for _ in range(2)]
    weights = str(tmp_path_factory.mktemp("dp") / "weights.pt")
    torch.save(_state_tree(variables), weights)
    # the ranks (and rank 1's one-process run) work while JAX compiles here;
    # tiny_config() rematerializes, and a second pair of ranks runs the same
    # steps without remat
    started = start(dp_check.rank_steps, WORLD, tiny_config(), weights, steps, "cpu", True, True,
                    device="cpu", threads=1)
    plain_cfg = tiny_config()
    plain_cfg = dataclasses.replace(plain_cfg,
                                    model=dataclasses.replace(plain_cfg.model, remat=False))
    started_plain = start(dp_check.rank_steps, WORLD, plain_cfg, weights, steps[:1], "cpu",
                          False, True, device="cpu", threads=1)
    jax_out = _jax_side(cfg, variables, *steps[0])
    ranks = started.join()
    return dict(cfg=cfg, steps=steps, ranks=ranks, one=ranks[1]["whole"], jax=jax_out,
                plain=started_plain.join())


def test_dp_losses_and_state_against_the_jax_mesh_step(env):
    (ref_l, ref_nets, _), (nud_l, nud_nets, _) = env["jax"]
    port = env["ranks"][0]
    for k, v in port["losses"][0].items():
        assert_held(v, ref_l[k], [nud_l[k]], LOSS_REL, f"loss {k}")
    nets = port["states"][0]["nets"]
    held = 0
    for n, ref in ref_nets.items():
        for k in ref:
            if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
                assert_held(nets[n][k], ref[k], [nud_nets[n][k]], STATE_REL, f"{n}.{k}")
                held += 1
    assert held > 50, held


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES)
def test_dp_gradients_and_updates_against_the_jax_mesh_step(env, name):
    (_, ref_nets, ref_g), (_, nud_nets, nud_g) = env["jax"]
    snap = env["ranks"][0]["states"][0]
    lr = env["cfg"].train.lr
    top = max(float(np.abs(g).max()) for g in ref_g[name].values())
    assert set(snap["exp_avg"][name]) == set(ref_g[name])
    for k, g in ref_g[name].items():
        scale = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        assert_held(snap["exp_avg"][name][k] / (1 - B1), g, [nud_g[name][k]], GRAD_REL,
                    f"{name}.{k} applied grad", scale=scale)
        # the parameter after the step: where the gradient's sign is settled
        settled = np.abs(g) > 10.0 * np.abs(nud_g[name][k] - g).max() + GRAD_REL * scale
        p, ref = snap["nets"][name][k], ref_nets[name][k]
        assert np.abs(p - ref).max() <= 2 * lr * (1 + 1e-3), f"{name}.{k}"
        if settled.any():
            assert_held(p[settled], ref[settled], [nud_nets[name][k][settled]], PARAM_REL,
                        f"{name}.{k} updated", scale=float(np.abs(ref).max()))


def test_dp_two_steps_against_one_process_on_the_whole_batch(env):
    """The JAX package's invariant: pmean'd gradients and synchronized
    BatchNorm are the whole batch's math, F rescaled by the ranks.  Both
    ranks hold the same state and log the same (mean) losses; rank 0's
    one-rank group and no group give the same bits."""
    r0, r1 = env["ranks"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 2
    for n, sd in r0["states"][-1]["nets"].items():
        for k, v in sd.items():
            assert np.array_equal(v, r1["states"][-1]["nets"][n][k]), (n, k)
    assert r0["world1_same"], r0["world1_diff"]
    port, one = env["ranks"][0], env["one"]
    for i in range(2):
        dp = dict(port["losses"][i], F=port["losses"][i]["F"] * WORLD)
        ref = one["losses"][i]
        dev = max(abs(dp[k] - ref[k]) / max(1.0, abs(ref[k])) for k in ref)
        assert dev < 1e-2 * 25.0 ** i, (i, dp, ref)
        pdev = max(float(np.abs(v - one["states"][i]["nets"][n][k]).max())
                   for n, sd in port["states"][i]["nets"].items() for k, v in sd.items()
                   if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                                   "weight_u", "weight_v"))
        assert pdev < 1e-3 * (i + 1), (i, pdev)


def test_dp_remat_steps_are_the_plain_steps(env):
    """2 gloo ranks, a step with remat against one without it: bit for bit
    on each rank (BatchNorm's all-reduce runs again in the recompute, on
    both ranks alike)."""
    for rank, (rm, plain) in enumerate(zip(env["ranks"], env["plain"])):
        assert rm["losses"][:1] == plain["losses"], rank
        diff = dp_check.bit_differences(rm["states"][:1], plain["states"])
        assert not diff, (rank, diff[:8])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_training_tree(str(tmp_path_factory.mktemp("tree")), 16, 5, 2, 3)


def test_sharded_cache_tables_equal_the_jax_cache(tree):
    shape = (16, 16, 3)
    ref = jax_cache.DeviceFrameCache(tree, frame_shape=shape, num_workers=2,
                                     mesh=make_mesh(WORLD))
    ports = [device_cache.DeviceFrameCache(tree, frame_shape=shape, num_workers=2,
                                           world=WORLD, rank=r, device="cpu")
             for r in range(WORLD)]
    frames = np.asarray(ref.frames)
    for r, port in enumerate(ports):
        assert port.shard_identities == ref.shard_identities
        assert np.array_equal(port.clip_start, ref.clip_start)
        block = frames[r * ref.shard_size:(r + 1) * ref.shard_size]
        assert np.array_equal(port.frames.numpy(), block[:port.frames.shape[0]])
        ra, rb = np.random.RandomState(3), np.random.RandomState(3)
        for batch in (2, 4, 6):
            (sa, da), (sb, db) = port.sample_indices(ra, batch), ref.sample_indices(rb, batch)
            assert np.array_equal(sa, sb) and np.array_equal(da, db)
            local = port.local(sa)
            assert np.array_equal(port.gather(local).numpy(),
                                  np.asarray(ref.gather(sb))[r * batch // 2:(r + 1) * batch // 2])
        la = device_cache.CachedLoader(port, 4, num_items=20, seed=2)
        lb = jax_cache.CachedLoader(ref, 4, num_items=20, seed=2)
        la.set_epoch(1)
        lb.set_epoch(1)
        chunks = list(la.iter_index_chunks(2))
        assert [c[0].shape for c in chunks] == [(2, 4), (2, 4), (1, 4)]
        for (s, d), (s2, d2) in zip(chunks, lb.iter_index_chunks(2), strict=True):
            assert np.array_equal(s, s2) and np.array_equal(d, d2)
        flat = [np.stack([port.local(si) for si in s]) for s, _ in chunks]
        for (s_b, _), rows in zip(la, (row for f in flat for row in f)):
            assert np.array_equal(s_b.numpy(), port.gather(rows).numpy())
