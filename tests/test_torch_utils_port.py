"""The port's order-zip of the reference's own state dicts
(facevae_tpu_torch/utils_port.py) and its checkpoint converter
(facevae_tpu_torch/convert_reference_checkpoint.py) against the JAX
package's (facevae_tpu/utils_port.py, tools/convert_reference_checkpoint.py).

The JAX route is port_torch_to_flax over the eager init's variables, then
convert.load_jax_variables onto a port net; the port's route is
port_reference_state_dict.  The two must give the same bits at every leaf
of the seven nets.  The JAX eager init takes minutes, so its results come
from the goldens of tests/make_torch_reference_golden.py: the tiny golden's
JAX output, and the creation order from which a template is rebuilt here
to run port_torch_to_flax (numpy only) live.  The slow test reruns the
eager init against the committed order.
"""
import copy
import json

import numpy as np
import pytest
import torch

from facevae_tpu import utils_port as jax_utils_port
from facevae_tpu_torch import convert, convert_reference_checkpoint, utils_port
from facevae_tpu_torch.config import Config, tiny_config
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.train import checkpoint, create_train_state
from chip_smoke import reference_state_dict
from facevae_tpu_torch.convert_reference_checkpoint import MODELS
from make_torch_reference_golden import (CONFIGS, GOLDEN, ORDER, SEED, creation_order,
                                         eager_variables, jax_config)


@pytest.fixture(scope="module")
def orders():
    with open(ORDER) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def golden():
    """{net: (reference state dict in file order, JAX variables)}."""
    with np.load(GOLDEN) as data:
        flat = {k: data[k] for k in data.files}
    out = {}
    for n in MODELS:
        ref = {k[len(f"ref/{n}/"):]: v for k, v in flat.items() if k.startswith(f"ref/{n}/")}
        jax = convert.nested_from_flat({k[len(f"jax/{n}/"):]: v for k, v in flat.items()
                                        if k.startswith(f"jax/{n}/")})
        out[n] = (ref, jax)
    return out


def port_nets(cfg):
    return build_models(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0),
                        names=MODELS)


@pytest.fixture(scope="module")
def tiny_nets():
    return port_nets(tiny_config())


def through_jax(net, variables):
    """``variables`` (a JAX net's) on a copy of ``net``, as its state dict."""
    return convert.load_jax_variables(copy.deepcopy(net), variables).state_dict()


def assert_same_bits(got, want, what):
    assert list(got) == list(want), what
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), f"{what}: {k}"


def jax_template(order):
    """The JAX variables of one net, zeros, rebuilt in creation order from
    its committed order (the dicts' insertion order is what the JAX zip
    walks)."""
    cols = {"params": {}, "batch_stats": {}, "spectral": {}}

    def put(col, path, leaf, shape):
        node = cols[col]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(shape, np.float32)

    for row in order:
        path = row["path"].split("/")
        for leaf, shape in row["leaves"].items():
            if leaf.startswith("bn_"):
                put("batch_stats", path, leaf[3:], shape)
            else:
                put("params", path, leaf, shape)
        for leaf, shape in row.get("spectral", {}).items():
            put("spectral", path, leaf, shape)
    return {c: v for c, v in cols.items() if v}


def port_with_jax(sd, order):
    """JAX's port_torch_to_flax over the template of ``order``, live."""
    tmpl = jax_template(order)
    spectral = tmpl.get("spectral")
    params, stats = jax_utils_port.port_torch_to_flax(
        sd, tmpl["params"], tmpl.get("batch_stats"), spectral=spectral)
    out = {"params": params}
    if stats is not None:
        out["batch_stats"] = stats
    if spectral is not None:
        out["spectral"] = spectral
    return out


def port_order(net):
    """The port's module stream in the committed order's terms: flax leaf
    names and layouts, the spectral u / v apart."""
    as_is = convert.weight_as_is(net)
    rows = []
    for mod, leaves in utils_port.port_module_stream(net):
        row = {"path": mod.replace(".", "/"), "leaves": {}}
        for leaf, t in leaves.items():
            shape = list(t.shape)
            if leaf == "weight" and f"{mod}.weight" not in as_is:
                if t.dim() >= 2:
                    row["leaves"]["kernel"] = (shape[::-1] if t.dim() == 2
                                               else shape[2:] + [shape[1], shape[0]])
                else:
                    row["leaves"]["scale"] = shape
            elif leaf in ("weight", "bias"):
                row["leaves"][leaf] = shape
            elif leaf in ("running_mean", "running_var"):
                row["leaves"]["bn_" + leaf[len("running_"):]] = shape
            elif leaf in ("weight_u", "weight_v"):
                row.setdefault("spectral", {})[leaf[-1]] = shape
            else:
                raise AssertionError(f"{mod}: leaf {leaf}")
        rows.append(row)
    return rows


def test_port_matches_the_jax_golden(golden, tiny_nets):
    """Every leaf of the seven nets at tiny_config: the port's zip of the
    golden's reference state dicts, bit for bit what the JAX package's zip
    made of them (through convert.load_jax_variables)."""
    for n in MODELS:
        ref, jax = golden[n]
        got = utils_port.port_reference_state_dict(ref, tiny_nets[n])
        assert_same_bits(got, through_jax(tiny_nets[n], jax), n)


def test_port_matches_jax_live(orders, tiny_nets):
    """port_torch_to_flax run here on fresh seeded state dicts, over a
    template rebuilt from the committed creation order: the same bits."""
    for i, n in enumerate(MODELS):
        order = orders["tiny_config"][n]
        sd = reference_state_dict(order, 1000 + SEED + i)
        got = utils_port.port_reference_state_dict(sd, tiny_nets[n])
        assert_same_bits(got, through_jax(tiny_nets[n], port_with_jax(sd, order)), n)
        # every leaf came from the state dict: none kept the port's seeded value
        # (but a spectral u of one value, a unit vector: +-1 on both sides)
        own = tiny_nets[n].state_dict()
        kept = [k for k in own if own[k].numel() > 1 and torch.equal(got[k], own[k])]
        assert not kept, f"{n}: {kept[:4]}"


@pytest.mark.parametrize("config", CONFIGS)
def test_registration_order_is_the_jax_creation_order(orders, config):
    """The port's modules with parameters or buffers, in registration order,
    with their shapes (in flax's layouts) and the spectral u / v: the JAX
    package's eager creation order, net by net."""
    cfg = tiny_config() if config == "tiny_config" else Config()
    nets = port_nets(cfg)
    for n in MODELS:
        assert port_order(nets[n]) == orders[config][n], n


def _truncated(sd):
    last = next(reversed(sd)).rsplit(".", 1)[0]
    return {k: v for k, v in sd.items() if not k.startswith(last + ".")}


def _extra(sd):
    return {**sd, "layers.999.weight": np.zeros((4, 4), np.float32)}


def _mismatched(sd):
    key = [k for k, v in sd.items() if k.endswith(("weight", "weight_orig")) and v.ndim >= 2][-1]
    return {**sd, key: np.zeros(sd[key].shape[:-1] + (sd[key].shape[-1] + 1,), np.float32)}


@pytest.mark.parametrize("case,message", [
    (_truncated, "ran out of torch modules at"),
    (_extra, r"1 torch modules left unported: \['layers\.999'\]"),
    (_mismatched, "shape mismatch at")])
def test_failures_raise_alike(orders, tiny_nets, case, message):
    """A truncated state dict, one with a torch module left over and one
    with a shape mismatch: ValueError from both packages, with the same
    words."""
    for i, n in enumerate(MODELS):
        order = orders["tiny_config"][n]
        sd = case(reference_state_dict(order, SEED + i))
        with pytest.raises(ValueError, match=message):
            port_with_jax(sd, order)
        with pytest.raises(ValueError, match=message):
            utils_port.port_reference_state_dict(sd, tiny_nets[n])


def test_cli_epoch_file_reads_back(golden, tmp_path, monkeypatch):
    """python -m facevae_tpu_torch.convert_reference_checkpoint on a
    reference checkpoint of the golden's nets (at tiny_config: the CLI's
    config patched): the epoch file reads back through
    train/checkpoint.load_checkpoint with the seven nets equal, bit for
    bit, to the JAX package's conversion; epoch set, step 0, Adam fresh."""
    opt = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=2e-4, betas=(0.5, 0.999))
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    opt.step()
    ckp = {n: {k: torch.from_numpy(v) for k, v in golden[n][0].items()} for n in MODELS}
    ckp.update({"optimizer_generator": opt.state_dict(), "epoch": 44})
    src = tmp_path / "00000044-checkpoint.pth.tar"
    torch.save(ckp, src)
    monkeypatch.setattr(convert_reference_checkpoint, "build_config",
                        lambda args: tiny_config())
    path = convert_reference_checkpoint.main(
        ["--torch_ckp", str(src), "--out_dir", str(tmp_path / "ckp"), "--epoch", "44",
         "--device", "cpu"])
    assert path == checkpoint.checkpoint_path(str(tmp_path / "ckp"), 44)
    state = checkpoint.load_checkpoint(str(tmp_path / "ckp"), 44,
                                       create_train_state(tiny_config(), "cpu"))
    assert (state.epoch, state.step) == (44, 0)
    assert not state.g_opt.state and not state.d_opt.state
    for n in MODELS:
        assert_same_bits(state.nets[n].state_dict(),
                         through_jax(state.nets[n], golden[n][1]), n)


@pytest.mark.slow
def test_order_golden_is_the_eager_init(orders):
    """The committed order is the JAX package's eager creation order (the
    maker's own computation, rerun: minutes on a CPU)."""
    for config in CONFIGS:
        variables = eager_variables(jax_config(config))
        assert {n: creation_order(variables[n]) for n in MODELS} == orders[config], config

