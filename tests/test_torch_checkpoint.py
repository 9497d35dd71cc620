"""PyTorch port: epoch checkpoints (facevae_tpu_torch/train/checkpoint.py and
msgpack_io.py) against the JAX package's (facevae_tpu/train/checkpoint.py,
flax.serialization), at tiny_config() on the CPU.

One JAX train state (every tree filled from a numpy seed,
tools/make_torch_golden.py:train_variables) takes one step of the JAX
package's jitted step, so both Adam states hold nonzero moments at count 1,
and the JAX package saves it as epoch 4 (~218 MB).  Then:

- JAX -> port: the port's load_checkpoint fills every net and both torch
  Adams; every leaf equals the JAX tree's under the bridge's layout rules,
  bit for bit.
- The served frames: the port's server built from that file
  (serve.build_engine) against the JAX pipeline over the same variables,
  1e-4 of max|ref| per output (tests/test_torch_pipeline.py's tolerance).
- One further step from the loaded state, against the JAX step from the
  saved one (same images and TPS parameters), held as
  tests/test_torch_train.py holds a step (torch_parity.assert_held: 10x the
  JAX step's own change under inputs nudged by 2^-20 and in float64 mode,
  plus 1e-4 of |ref| for the losses and 1e-3 of the scale for the Adam
  moments and the parameter updates, a leaf's scale at least 1e-2 of its
  net's largest).  A moment mapped to the wrong leaf, or a step count off
  by one, moves the update by a factor of order 1.
- Port -> JAX: the port's save_checkpoint (seeded Adam moments at step 3),
  then facevae_tpu.train.load_checkpoint into a JAX template: the file's
  tree has the template's structure and shapes, and every leaf equals the
  port's bit for bit, with and without LossConfig.train_contrastive_head.
- The codec against msgpack and flax.serialization on seeded trees, bytes
  equal both ways; atomic writes and retention as
  tests/test_checkpoint_logger.py shows for the JAX package.
"""
import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from facevae_tpu import train as jtrain
from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu.ops.tps import TransformParams as JaxTransformParams
from facevae_tpu.train.state import make_optimizers as jax_make_optimizers
from facevae_tpu.train.step import make_train_step
from facevae_tpu_torch import serve
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import net_variables, state_dict_from_jax
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.ops.tps import TransformParams
from facevae_tpu_torch.train import checkpoint as ckpt
from facevae_tpu_torch.train import create_train_state, msgpack_io, train_step
from torch_parity import assert_close, assert_held, golden, one_torch_thread  # noqa: F401

NETS = G_MODEL_NAMES + D_MODEL_NAMES + ("hopenet", "perceptual", "contrastive")
EPOCH = 4
NUDGE = 2.0 ** -20
LOSS_REL, MOMENT_REL, FLOOR = 1e-4, 1e-3, 1e-2
SERVE_REL = 1e-4


def _tree(jstate):
    """A JAX TrainState as the nested-numpy state dict its file holds."""
    return jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate))


def _cast(tree, dtype):
    return jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating)
                        else a, tree)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    cfg = jax_tiny_config()
    models, variables = golden.train_variables(cfg, seed=31)
    rs = np.random.RandomState(8)
    N, size = 2, cfg.model.image_size
    batch = tuple(rs.rand(N, size, size, 3).astype(np.float32) for _ in range(4))
    tp = (np.eye(2, 3, dtype=np.float32)[None] + 0.05 * rs.randn(N, 2, 3).astype(np.float32),
          np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2),
          (0.005 * rs.randn(N, 1, 25)).astype(np.float32))
    _, jstep = make_train_step(cfg, models=models, donate=False)

    def step(jstate, b, dtype=np.float32):
        return jstep(_cast(jstate, dtype), tuple(jnp.asarray(a, dtype) for a in b),
                     jax.random.PRNGKey(0), JaxTransformParams(*(jnp.asarray(a, dtype) for a in tp)))

    jstate, _ = step(golden.jax_train_state(cfg, variables), batch)
    jstate = jstate.replace(epoch=jnp.asarray(EPOCH, jnp.int32))
    ckp_dir = str(tmp_path_factory.mktemp("jax_ckp"))
    path = jtrain.save_checkpoint(ckp_dir, jstate, EPOCH)
    nudged = tuple(b * (1 + NUDGE * rs.randn(*b.shape)).astype(np.float32) for b in batch)
    return dict(cfg=cfg, variables=variables, batch=batch, tp=tp, jstate=jstate,
                tree=_tree(jstate), ckp_dir=ckp_dir, path=path, step=step, nudged=nudged)


def _port_state(head=False):
    cfg = tiny_config()
    if head:
        cfg = dataclasses.replace(cfg, loss=dataclasses.replace(cfg.loss,
                                                                train_contrastive_head=True))
    return create_train_state(cfg, "cpu")


@pytest.fixture(scope="module")
def loaded(env):
    return ckpt.load_checkpoint(env["ckp_dir"], EPOCH, _port_state())


def _named(opt, nets):
    names = {id(p): (n, k) for n, net in nets.items() for k, p in net.named_parameters()}
    return [names[id(p)] + (p,) for g in opt.param_groups for p in g["params"]]


def _assert_adam_equal(opt, nets, adam):
    """Every parameter's torch Adam state equals optax's, leaf for leaf."""
    mu = {n: state_dict_from_jax({"params": t}) for n, t in adam["mu"].items()}
    nu = {n: state_dict_from_jax({"params": t}) for n, t in adam["nu"].items()}
    named = _named(opt, nets)
    assert sorted({n for n, _, _ in named}) == sorted(mu) == sorted(nu)
    for n, k, p in named:
        st = opt.state[p]
        assert float(st["step"]) == int(adam["count"]) > 0
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[n][k], f"{n}.{k}")
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[n][k], f"{n}.{k}")


@pytest.mark.parametrize("name", NETS)
def test_jax_checkpoint_fills_every_net(env, loaded, name):
    ref = state_dict_from_jax(net_variables(env["tree"], name))
    own = loaded.nets[name].state_dict()
    assert set(ref) == set(own)
    for k, v in own.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], f"{name}.{k}")


@pytest.mark.parametrize("key", ["g_opt", "d_opt"])
def test_jax_checkpoint_fills_the_adam_states(env, loaded, key):
    assert set(env["tree"][key]) == {"0", "1"} and env["tree"][key]["1"] == {}
    _assert_adam_equal(getattr(loaded, key), loaded.nets, env["tree"][key]["0"])
    assert (loaded.epoch, loaded.step) == (EPOCH, 1)


def test_load_is_strict(env, tmp_path):
    """A file whose trees miss a net (here the head's params), or a state
    whose optimizer covers the head when the file's does not, raises before
    anything is filled."""
    tree = {k: {n: {} for n in v} for k, v in env["tree"].items()
            if k in ckpt.STATE_KEYS[:6]}
    tree.update(c_params={}, g_opt={}, d_opt={}, epoch=np.int32(0), step=np.int32(0))
    with open(ckpt.checkpoint_path(str(tmp_path), 0), "wb") as f:
        msgpack_io.dump(tree, f)
    with pytest.raises(ValueError, match="no state"):
        ckpt.load_checkpoint(str(tmp_path), 0, _port_state())
    state = _port_state(head=True)
    kept = {k: v.clone() for k, v in state.nets["generator"].state_dict().items()}
    with pytest.raises(ValueError, match="covers"):
        ckpt.load_checkpoint(env["ckp_dir"], EPOCH, state)
    for k, v in state.nets["generator"].state_dict().items():
        assert torch.equal(v, kept[k]), k


def _serve_args(env, epoch=EPOCH):
    return serve.parse_args(["--ckp_dir", env["ckp_dir"], "--ckp", str(epoch), "--device", "cpu",
                             "--tiny", "true", "--image_size", str(env["cfg"].model.image_size),
                             "--max_batch", "2"])


@pytest.fixture(scope="module")
def served(env):
    engine = serve.build_engine(_serve_args(env))
    rs = np.random.RandomState(12)
    size = env["cfg"].model.image_size
    s, d = (rs.rand(2, size, size, 3).astype(np.float32) for _ in range(2))
    tree = env["tree"]
    ref = golden.jax_pipeline(env["cfg"], {n: net_variables(tree, n) for n in G_MODEL_NAMES})
    ref_enc = ref.encode_source(s)
    port_enc = engine.pipe.encode_source(torch.from_numpy(s))
    outs = {k: (p, r) for k, p, r in zip(("fs", "kp_c", "kp_s", "Rs"), port_enc, ref_enc)}
    outs["drive"] = (engine.pipe.drive_frame(*port_enc, torch.from_numpy(d)),
                     ref.drive_frame(*ref_enc, d))
    outs["frontalize"] = (engine.pipe.frontalize_frame(torch.from_numpy(d)),
                          ref.frontalize_frame(d))
    # through the collector: one request, padded with a zero frame to --max_batch 2
    outs["engine"] = (engine.frontalize(d[0], timeout=300.0),
                      ref.frontalize_frame(np.stack([d[0], np.zeros_like(d[0])]))[0])
    yield outs
    engine.stop()


@pytest.mark.parametrize("out", ["fs", "kp_c", "kp_s", "Rs", "drive", "frontalize", "engine"])
def test_server_from_the_jax_file_matches_the_jax_pipeline(served, out):
    port, ref = served[out]
    assert_close(port, np.asarray(ref), SERVE_REL, out)


def test_server_refuses_a_missing_epoch(env):
    with pytest.raises(FileNotFoundError):
        serve.build_engine(_serve_args(env, EPOCH + 1))


@pytest.fixture(scope="module")
def stepped(env):
    """The port's step from the loaded state; the JAX step from the saved
    one on the images, on the nudged images and in float64 mode."""
    state = ckpt.load_checkpoint(env["ckp_dir"], EPOCH, _port_state())
    before = {n: {k: v.clone() for k, v in state.nets[n].named_parameters()}
              for n in G_MODEL_NAMES + D_MODEL_NAMES}
    out = train_step(state, tuple(torch.from_numpy(a.copy()) for a in env["batch"]),
                     transform_params=TransformParams(*(torch.from_numpy(a.copy())
                                                        for a in env["tp"])))
    refs = []
    for b, dtype in ((env["batch"], np.float32), (env["nudged"], np.float32),
                     (env["batch"], np.float64)):
        with jax.enable_x64(dtype == np.float64):
            jstate, metrics = env["step"](env["jstate"], b, dtype)
            refs.append((jax.tree.map(np.asarray, {**metrics["losses_g"], **metrics["losses_d"]}),
                         _tree(jstate)))
    return state, before, out, refs


def test_step_from_the_loaded_state_losses(stepped):
    state, _, out, refs = stepped
    port = {**out["losses_g"], **out["losses_d"]}
    assert set(port) == set(refs[0][0])
    for k, v in port.items():
        assert_held(v, refs[0][0][k], [r[0][k] for r in refs[1:]], LOSS_REL, f"loss {k}")
    assert (state.step, state.epoch) == (2, EPOCH)


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES)
def test_step_from_the_loaded_state_moments_and_update(env, stepped, name):
    """exp_avg, exp_avg_sq and the parameter update of the step, held per
    leaf to the JAX step's mu, nu and update."""
    state, before, _, refs = stepped
    key = "d_opt" if name in D_MODEL_NAMES else "g_opt"
    opt = getattr(state, key)
    params = dict(state.nets[name].named_parameters())
    p0 = state_dict_from_jax({"params": env["tree"]["d_params" if key == "d_opt"
                                                    else "g_params"][name]})
    col = "d_params" if key == "d_opt" else "g_params"
    for what in ("mu", "nu", "update"):
        if what == "update":
            port = {k: params[k].detach() - before[name][k] for k in params}
            trees = [{k: v - p0[k] for k, v in state_dict_from_jax({"params": r[1][col][name]}).items()}
                     for r in refs]
        else:
            field = "exp_avg" if what == "mu" else "exp_avg_sq"
            port = {k: opt.state[p][field] for k, p in params.items()}
            trees = [state_dict_from_jax({"params": r[1][key]["0"][what][name]}) for r in refs]
        top = max(float(np.abs(v).max()) for v in trees[0].values())
        assert set(port) == set(trees[0])
        for k, v in port.items():
            r = trees[0][k]
            assert_held(v, r, [t[k] for t in trees[1:]], MOMENT_REL, f"{name}.{k} {what}",
                        scale=max(float(np.abs(r).max()), FLOOR * top))


def _seed_adam(opt, seed, step=3):
    """Seeded moments at ``step`` for every parameter of ``opt``."""
    g = torch.Generator().manual_seed(seed)
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"step": torch.tensor(float(step)),
                            "exp_avg": torch.randn(p.shape, generator=g),
                            "exp_avg_sq": torch.rand(p.shape, generator=g)}


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return (tuple(np.shape(tree)), str(np.asarray(tree).dtype))


@pytest.mark.parametrize("head", [False, True], ids=["frozen_head", "trained_head"])
def test_port_checkpoint_loads_into_the_jax_package(env, tmp_path, head):
    state = _port_state(head)
    _seed_adam(state.g_opt, 1)
    _seed_adam(state.d_opt, 2)
    state.epoch, state.step = 6, 30
    path = ckpt.save_checkpoint(str(tmp_path), state, 6)
    assert path == ckpt.checkpoint_path(str(tmp_path), 6) and os.listdir(tmp_path) == [
        os.path.basename(path)]

    jcfg = env["cfg"]
    if head:
        jcfg = dataclasses.replace(jcfg, loss=dataclasses.replace(jcfg.loss,
                                                                  train_contrastive_head=True))
    template = golden.jax_train_state(jcfg, env["variables"])
    if head:
        g_tx, _ = jax_make_optimizers(jcfg)
        template = template.replace(g_opt=g_tx.init(
            {**template.g_params, "contrastive": template.c_params["contrastive"]}))
    assert _structure(msgpack_io.load(path)) == _structure(_tree(template))
    tree = _tree(jtrain.load_checkpoint(str(tmp_path), 6, template))
    assert int(tree["epoch"]) == 6 and int(tree["step"]) == 30
    for name in NETS:
        ref = state_dict_from_jax(net_variables(tree, name))
        for k, v in state.nets[name].state_dict().items():
            np.testing.assert_array_equal(v.numpy(), ref[k], f"{name}.{k}")
    for key in ("g_opt", "d_opt"):
        _assert_adam_equal(getattr(state, key), state.nets, tree[key]["0"])
    assert ("contrastive" in tree["g_opt"]["0"]["mu"]) == head


def _codec_trees(rs):
    f32 = rs.randn(3, 5).astype(np.float32)
    bf16 = rs.randn(4, 6).astype(np.float32)
    return {
        "fp32": ({"w": f32, "b": {"v": f32[0].copy()}},) * 2,
        "bf16": ({"w": jnp.asarray(bf16, jnp.bfloat16)},
                 {"w": torch.from_numpy(bf16).bfloat16()}),
        "int32_scalar": ({"count": np.int32(7), "step": np.asarray(3, np.int32)},) * 2,
        "empty_dict": ({"0": {"count": np.asarray(0, np.int32)}, "1": {}},) * 2,
        "nested_tuples": ((f32, (f32[1], {"x": (np.arange(4, dtype=np.int32),)})),) * 2,
        "chunked": ({"big": rs.randn(10, 7).astype(np.float32),
                     "big_bf16": jnp.asarray(rs.randn(50), jnp.bfloat16)},
                    {"big": None, "big_bf16": None}),
    }


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _assert_trees_equal(got, want):
    if isinstance(want, (dict, tuple, list)):
        want = (dict(want) if isinstance(want, dict)
                else {str(i): v for i, v in enumerate(want)})
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    else:
        g, w = _np(got), _np(want)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["fp32", "bf16", "int32_scalar", "empty_dict",
                                  "nested_tuples", "chunked"])
def test_codec_against_flax_and_msgpack(monkeypatch, case):
    """flax's bytes decode to the tree; the port's bytes equal flax's and
    decode in msgpack and flax as flax's do.  The chunked case sets flax's
    MAX_CHUNK_SIZE to 64 bytes (the port keeps 2**30 and writes the arrays
    whole, which flax reads)."""
    jax_tree, port_tree = _codec_trees(np.random.RandomState(3))[case]
    if case == "chunked":
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    ref = flax.serialization.to_bytes(jax_tree)
    got = msgpack_io.loads(ref)
    _assert_trees_equal(got, jax_tree)
    if case == "chunked":
        assert b"__msgpack_chunked_array__" in ref
        port_tree = got
    mine = msgpack_io.dumps(port_tree)
    if case != "chunked":
        assert mine == ref
    _assert_trees_equal(flax.serialization.msgpack_restore(mine), jax_tree)
    raw = msgpack.unpackb(mine, raw=False, strict_map_key=False)
    assert isinstance(raw, dict) and set(raw) == set(got)


def test_atomic_writes_and_retention(env, loaded, tmp_path):
    """A leftover .tmp is never listed; keep=3 leaves the three newest
    epochs; keep <= 0 never prunes; the latest retained epoch restores."""
    d = str(tmp_path)
    assert ckpt.latest_checkpoint_epoch(d) is None and ckpt.list_checkpoints(d) == []
    for e in range(4):
        open(ckpt.checkpoint_path(d, e), "wb").close()
    open(ckpt.checkpoint_path(d, 9) + ".tmp", "wb").close()      # a torn write
    ckpt.save_checkpoint(d, loaded, 4, keep=3)
    assert [e for e, _ in ckpt.list_checkpoints(d)] == [2, 3, 4]
    assert ckpt.latest_checkpoint_epoch(d) == 4
    restored = ckpt.load_checkpoint(d, ckpt.latest_checkpoint_epoch(d), _port_state())
    assert (restored.epoch, restored.step) == (EPOCH, 1)
    assert ckpt.prune_checkpoints(d, 0) == [] and len(ckpt.list_checkpoints(d)) == 3
    open(ckpt.checkpoint_path(d, 5), "wb").close()
    ckpt.prune_checkpoints(d, keep=1)
    assert [e for e, _ in ckpt.list_checkpoints(d)] == [5]
    assert os.path.exists(ckpt.checkpoint_path(d, 9) + ".tmp")


def test_async_checkpointer_writes_the_snapshot(loaded, tmp_path):
    """The file holds the state as it was at save(), though the state changes
    before the write ends; it equals save_checkpoint's bytes."""
    sync = ckpt.save_checkpoint(str(tmp_path / "sync"), loaded, 1)
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path / "async"), loaded, 1)
    p = next(loaded.nets["generator"].parameters())
    kept = p.detach().clone()
    with torch.no_grad():
        p.add_(1.0)
    saver.wait()
    with torch.no_grad():
        p.copy_(kept)
    with open(sync, "rb") as f, open(ckpt.checkpoint_path(str(tmp_path / "async"), 1), "rb") as g:
        assert f.read() == g.read()
