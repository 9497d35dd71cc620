#!/usr/bin/env python
"""Write the JAX golden for the PyTorch port: tests/data/torch_golden_tiny.npz.

Runs on the CPU.  It builds the six generator-side nets of tiny_config() with
facevae_tpu.models.build_models, fills their variables from a seeded numpy
RandomState (shapes from jax.eval_shape of each net's init; see
g_variables), runs the JAX InferencePipeline's encode_source, drive_frame and
frontalize_frame on two source and two driving images, and saves

  var/<net>/<collection>/<path>   the variables (numpy, JAX layouts)
  in/source, in/driving           the images [2,64,64,3] in [0,1]
  out/fs, out/kp_c, out/kp_s, out/Rs, out/drive, out/frontalize

chip_smoke.py checks the port against it on the card, and
tests/test_torch_pipeline.py checks it on the CPU.  The parity tests use the
helpers below too: g_variables for the six G nets, train_variables and
jax_train_state for a whole JAX train state (the seven trainable nets, the
frozen teachers and the contrastive head, every tree filled from one numpy
seed), and make_step_grads / jax_step_grads for the gradients of one JAX
step.

Usage:  python tools/make_torch_golden.py [--out PATH] [--seed 0]
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

GOLDEN = os.path.join(_ROOT, "tests", "data", "torch_golden_tiny.npz")


def _init_args(cfg, n=1):
    """Dummy inputs of each net's init (as in facevae_tpu/train/state.py)."""
    import jax.numpy as jnp
    m = cfg.model
    img = jnp.zeros((n, m.image_size, m.image_size, 3), jnp.float32)
    kp = jnp.zeros((n, m.num_kp, 3), jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
    hq = m.image_size // 4
    fs = jnp.zeros((n, m.depth, hq, hq, m.app_channels), jnp.float32)
    return {"afe": (img,), "ckd": (img,), "hpe_ede": (img,), "efe": (img, img, kp),
            "mfe": (fs, kp, kp, eye, eye),
            "generator": (fs, jnp.zeros((n, m.depth, hq, hq, 3), jnp.float32),
                          jnp.zeros((n, hq, hq, 1), jnp.float32))}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def fill_variables(shapes, rs):
    """Fill one net's variable shapes with values a trained net could hold:
    kernels and biases U(-2/sqrt(fan_in), +) — twice torch's default bound,
    so activations keep their scale through the nets (at 1x EFE's heatmaps
    flatten and kp_s collapses to ~0) — norm scales near 1, norm biases and
    running means near 0, running variances in [0.5, 1.5], and spectral u/v
    from power iterations on the filled kernel (so sigma is the spectral
    norm, not the near-zero sigma of random u/v)."""
    f32 = np.float32
    params = dict(_flat(shapes.get("params", {})))
    out = {"params": {}, "batch_stats": {}, "spectral": {}}
    for path, s in sorted(params.items()):
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel" or (leaf == "bias" and mod + ("kernel",) in params):
            fan_in = math.prod(params[mod + ("kernel",)].shape[:-1])
            bound = 2.0 / math.sqrt(fan_in)
            out["params"][path] = rs.uniform(-bound, bound, s.shape).astype(f32)
        elif leaf == "scale":
            out["params"][path] = rs.uniform(0.8, 1.2, s.shape).astype(f32)
        else:                                            # norm bias
            out["params"][path] = rs.uniform(-0.1, 0.1, s.shape).astype(f32)
    for path, s in sorted(_flat(shapes.get("batch_stats", {}))):
        lo, hi = (-0.1, 0.1) if path[-1] == "mean" else (0.5, 1.5)
        out["batch_stats"][path] = rs.uniform(lo, hi, s.shape).astype(f32)
    for path, _ in sorted(_flat(shapes.get("spectral", {}))):
        if path[-1] != "u":
            continue
        mod = path[:-1]
        k = out["params"][mod + ("kernel",)]
        w = k.reshape(-1, k.shape[-1]).T.astype(np.float64)     # [O, fan_in]
        u = rs.randn(w.shape[0])
        for _ in range(30):
            v = w.T @ u
            v /= np.linalg.norm(v)
            u = w @ v
            u /= np.linalg.norm(u)
        out["spectral"][mod + ("u",)] = u.astype(f32)
        out["spectral"][mod + ("v",)] = v.astype(f32)
    return {col: _nest(flat) for col, flat in out.items() if col in shapes}


def g_variables(cfg, seed=0):
    """{net: {"params"|"batch_stats"|"spectral": nested numpy}} for the six
    G nets of ``cfg``.  jax.eval_shape gives the shapes without compiling
    (an eager init of the tiny nets takes ~100 s on a CPU)."""
    import jax
    from facevae_tpu.models import build_models
    from facevae_tpu.train.state import G_MODEL_NAMES
    models = build_models(cfg.model)
    args = _init_args(cfg)
    key = jax.random.PRNGKey(0)
    rs = np.random.RandomState(seed)
    out = {}
    for name in G_MODEL_NAMES:
        shapes = jax.eval_shape(
            lambda: models[name].init({"params": key, "noise": key}, *args[name]))
        out[name] = fill_variables(shapes, rs)
    return out


TRAIN_NETS = ("efe", "afe", "ckd", "hpe_ede", "mfe", "generator", "discriminator",
              "hopenet", "perceptual", "contrastive")


def train_variables(cfg, seed=0):
    """(the JAX modules, {net: filled variables}) for every module of the
    JAX train step, filled in TRAIN_NETS order from one numpy
    RandomState(seed): the teachers' ~46M parameters are regenerated from
    the seed, never stored."""
    import jax
    import jax.numpy as jnp
    from facevae_tpu.train.state import build_all_modules
    models = build_all_modules(cfg)
    m = cfg.model
    args = _init_args(cfg)
    img = jnp.zeros((1, m.image_size, m.image_size, 3), jnp.float32)
    feat = (m.image_size // 64) ** 2 * m.efe_down_seq[-1]
    args.update({"discriminator": (img, jnp.zeros((1, m.num_kp, 3), jnp.float32)),
                 "hopenet": (jnp.zeros((1, 224, 224, 3), jnp.float32),),
                 "perceptual": (img, img),
                 "contrastive": (jnp.zeros((2, feat), jnp.float32),) * 2})
    key = jax.random.PRNGKey(0)
    rs = np.random.RandomState(seed)
    out = {}
    for name in TRAIN_NETS:
        shapes = jax.eval_shape(
            lambda: models[name].init({"params": key, "noise": key}, *args[name]))
        out[name] = fill_variables(shapes, rs)
    return models, out


def jax_train_state(cfg, variables):
    """facevae_tpu's TrainState over ``variables`` (train_variables), with
    fresh Adam states, as create_train_state lays it out."""
    import jax.numpy as jnp
    from facevae_tpu.train.state import (D_MODEL_NAMES, G_MODEL_NAMES, TrainState,
                                         make_optimizers)
    g_params = {n: variables[n]["params"] for n in G_MODEL_NAMES}
    d_params = {n: variables[n]["params"] for n in D_MODEL_NAMES}
    g_tx, d_tx = make_optimizers(cfg)
    return TrainState(
        g_params=g_params, d_params=d_params,
        c_params={"contrastive": variables["contrastive"]["params"]},
        teachers={"hopenet": variables["hopenet"], "perceptual": variables["perceptual"]},
        batch_stats={n: v["batch_stats"] for n, v in variables.items()
                     if "batch_stats" in v and n not in ("hopenet", "perceptual")},
        spectral={n: v["spectral"] for n, v in variables.items() if "spectral" in v},
        g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params),
        epoch=jnp.zeros((), jnp.int32), step=jnp.zeros((), jnp.int32))


def train_state_tree(state):
    """The variables of a JAX TrainState as nested numpy, keyed as
    facevae_tpu_torch.convert.load_jax_train_state expects."""
    import jax
    return {k: jax.tree.map(np.asarray, getattr(state, k))
            for k in ("g_params", "d_params", "c_params", "teachers", "batch_stats",
                      "spectral")}


def make_step_grads(cfg, models, train_vae=False):
    """A function (state, batch, rng, transform_params) -> one JAX step's
    gradients, by the JAX package's own objective: the generator phase
    differentiated at ``state`` and the discriminator phase at the G phase's
    BN / spectral state, as facevae_tpu/train/step.py does (its step returns
    no gradients); ``train_vae`` as the step passes cfg.train.train_vae.
    Everything is an argument of the two jitted functions, so a second call
    at the same shapes and dtypes reuses their compilation.  The function
    returns a dict of numpy trees: losses_g, losses_d, g_grads, d_grads,
    batch_stats, spectral (after the D phase)."""
    import jax
    from facevae_tpu.train.objective import VarBank, discriminator_forward, generator_forward

    def g_loss(g_params, state, batch, rng, transform_params):
        s, d, s_a, d_a = batch
        bank = VarBank({**g_params, **state.d_params, **state.c_params},
                       state.batch_stats, state.spectral)
        losses, aux = generator_forward(models, state.teachers, bank, cfg, s, d, s_a, d_a,
                                        rng, train_vae=train_vae,
                                        transform_params=transform_params)
        return sum(losses.values()), (losses, aux, *bank.collections())

    def d_loss(d_params, state, stats, spectral, d, generated_d, kp_d):
        bank = VarBank({**state.g_params, **d_params, **state.c_params}, stats, spectral)
        losses = discriminator_forward(models, bank, cfg, d, generated_d, kp_d)
        return sum(losses.values()), (losses, *bank.collections())

    g_grad = jax.jit(jax.value_and_grad(g_loss, has_aux=True))
    d_grad = jax.jit(jax.value_and_grad(d_loss, has_aux=True))

    def step_grads(state, batch, rng, transform_params):
        (_, (losses_g, aux, stats, spectral)), g_grads = g_grad(
            state.g_params, state, batch, rng, transform_params)
        (_, (losses_d, stats, spectral)), d_grads = d_grad(
            state.d_params, state, stats, spectral, batch[1],
            jax.lax.stop_gradient(aux["generated_d"]), jax.lax.stop_gradient(aux["kp_d"]))
        return jax.tree.map(np.asarray, {"losses_g": losses_g, "losses_d": losses_d,
                                         "g_grads": g_grads, "d_grads": d_grads,
                                         "batch_stats": stats, "spectral": spectral})

    return step_grads


def jax_step_grads(cfg, models, state, batch, rng, transform_params, train_vae=False):
    """One JAX step's gradients (make_step_grads, compiled for this call)."""
    return make_step_grads(cfg, models, train_vae)(state, batch, rng, transform_params)


def jax_pipeline(cfg, variables):
    """facevae_tpu's InferencePipeline over ``variables`` (no TrainState:
    the pipeline reads only g_params, batch_stats and spectral)."""
    from facevae_tpu.train.inference import InferencePipeline
    state = types.SimpleNamespace(
        g_params={n: v["params"] for n, v in variables.items()},
        batch_stats={n: v["batch_stats"] for n, v in variables.items()
                     if "batch_stats" in v},
        spectral={n: v["spectral"] for n, v in variables.items() if "spectral" in v})
    return InferencePipeline(cfg, state)


def make_golden(seed=0):
    from facevae_tpu.config import tiny_config
    cfg = tiny_config()
    variables = g_variables(cfg, seed)
    rs = np.random.RandomState(seed + 1)
    size = cfg.model.image_size
    s = rs.rand(2, size, size, 3).astype(np.float32)
    d = rs.rand(2, size, size, 3).astype(np.float32)
    pipe = jax_pipeline(cfg, variables)
    fs, kp_c, kp_s, Rs = pipe.encode_source(s)
    arrays = {"/".join(("var",) + path): v for path, v in _flat(variables)}
    arrays.update({"in/source": s, "in/driving": d,
                   "out/fs": fs, "out/kp_c": kp_c, "out/kp_s": kp_s, "out/Rs": Rs,
                   "out/drive": pipe.drive_frame(fs, kp_c, kp_s, Rs, d),
                   "out/frontalize": pipe.frontalize_frame(d)})
    return {k: np.asarray(v) for k, v in arrays.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=GOLDEN)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    arrays = make_golden(args.seed)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    for k in ("out/drive", "out/frontalize"):
        a = arrays[k]
        print(f"{k}: shape {a.shape} min {a.min():.4f} max {a.max():.4f} std {a.std():.4f}")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    main()
