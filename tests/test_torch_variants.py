"""PyTorch port: the dormant EFE variants of the conv family at 128x128
(conv, conv2, conv4 and the active conv5, narrow widths), their VAEs, the
ELR layers and the embedder, each against facevae_tpu's module on weights
bridged by facevae_tpu_torch.convert, on the CPU; and the drive graph of
one variant.  tests/test_torch_variants_256.py holds the variants that
build at 256x256 only.

Every variant runs three ways on one numpy-seeded input, batch 2, in one
jitted JAX function: the eval form with the gradient of sum(kp * c) with
respect to the image, and the training form (BatchNorm on batch
statistics, whose running statistics are compared too; VAE sampling with
one eps given to both packages, JAX's draw patched to it).

Tolerances, max|err| <= REL * max|ref| per output:
- eval form 1e-4 (tests/test_torch_models.py's: fp32 convolutions in
  another summation order, amplified by the 0.1-temperature soft-argmax);
- training form 1e-3, running statistics 1e-4: BatchNorm over the few
  values of an encoder map of 1x1 or 2x2 divides by a small batch
  variance;
- input gradient 1e-3 of its scale.
The ELR layers and the embedder alone: 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu import models as jmodels
from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.models.embedder import get_embedder as jax_get_embedder
from facevae_tpu.nn import elr as jelr
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import (jax_tree_from_state_dict, load_jax_variables,
                                       state_dict_from_jax, weight_as_is)
from facevae_tpu_torch.models import build_models, get_embedder
from facevae_tpu_torch.nn import elr
from torch_parity import assert_close, fixed_normal, golden, one_torch_thread  # noqa: F401

EVAL_REL, TRAIN_REL, STATS_REL, GRAD_REL, LAYER_REL = 1e-4, 1e-3, 1e-4, 1e-3, 1e-5


def model_config(cfg, **kw):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))


def fill(shapes, rs):
    """Variables for ``shapes`` (jax.eval_shape of an init): the golden's
    filler, with the ELR layers' "weight" leaves N(0,1) as they are drawn."""
    def split(tree):
        """(tree without its "weight" leaves, their shapes by path)."""
        rest, weights = {}, {}
        for k, v in tree.items():
            if isinstance(v, dict):
                rest[k], sub = split(v)
                weights.update({(k,) + p: w for p, w in sub.items()})
            elif k == "weight":
                weights[(k,)] = v.shape
            else:
                rest[k] = v
        return rest, weights

    params, weights = split(shapes["params"])
    out = golden.fill_variables({**shapes, "params": params}, rs)
    draws = np.random.default_rng(rs.randint(2 ** 31))
    for path, shape in weights.items():
        node = out["params"]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = draws.standard_normal(shape, dtype=np.float32)
    return out


def variant_case(jcfg, variant, N, seed):
    """(JAX EFE, its variables, the port's EFE over them, inputs)."""
    jm = jmodels.build_models(jcfg.model)["efe"]
    size, K = jcfg.model.image_size, jcfg.model.num_kp
    rs = np.random.RandomState(seed)
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    kp0 = jnp.zeros((1, K, 3), jnp.float32)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "noise": key}, img, img, kp0))
    variables = fill(shapes, rs)
    pcfg = model_config(tiny_config(), **{f.name: getattr(jcfg.model, f.name)
                                          for f in dataclasses.fields(jcfg.model)})
    port = build_models(pcfg.model, "cpu", names=("efe",))["efe"]
    load_jax_variables(port, variables)
    x, x_a = (rs.rand(N, size, size, 3).astype(np.float32) for _ in range(2))
    kp = rs.uniform(-0.6, 0.6, (N, K, 3)).astype(np.float32)
    c = rs.randn(N, K, 3).astype(np.float32)
    return jm, variables, port, (x, x_a, kp, c)


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _leaves(x)]
    return [] if out is None else [out]


def jax_answers(jm, variables, inputs, eps, monkeypatch, eval_only=False):
    """The JAX EFE's (eval outputs, dx, training outputs, updated
    batch_stats), one jit; eval_only: (eval outputs,)."""
    x, x_a, kp, c = inputs
    if eps is not None:
        for mod in ("facevae_tpu.models.vae", "facevae_tpu.models.efe_linear"):
            monkeypatch.setattr(f"{mod}.jax", fixed_normal(eps))
    mutable = [k for k in variables if k != "params"]

    def eval_kp(v, x):
        out = jm.apply(v, x, x_a, kp, train=False)
        return jnp.sum(out[0] * c), out

    @jax.jit
    def run(v, x):
        if eval_only:
            return (jm.apply(v, x, x_a, kp, train=False),)
        dx, ev = jax.grad(eval_kp, argnums=1, has_aux=True)(v, x)
        tr, upd = jm.apply(v, x, x_a, kp, train_vae=eps is not None, train=True,
                           rngs={"noise": jax.random.PRNGKey(1)}, mutable=mutable)
        return ev, dx, tr, upd

    return jax.tree.map(np.asarray, run(variables, x))


def port_answers(port, inputs, eps, eval_only=False):
    """The port's answers in jax_answers' order."""
    x, x_a, kp, c = (torch.from_numpy(a) for a in inputs)
    if eval_only:
        with torch.no_grad():
            return (port.eval()(x, x_a, kp),)
    xg = x.clone().requires_grad_(True)
    ev = port.eval()(xg, x_a, kp)
    (ev[0] * c).sum().backward()
    with torch.no_grad():
        tr = port.train()(x, x_a, kp, train_vae=eps is not None,
                          eps=None if eps is None else torch.from_numpy(eps))
    return ev, xg.grad, tr


def check_variant(jm, variables, port, inputs, eps, monkeypatch, eval_only=False,
                  kp_rel=EVAL_REL):
    """Hold the port's EFE to the JAX one (the module docstring's forms and
    tolerances; kp_rel: the eval form's keypoints)."""
    # the bridge's way back gives the JAX variables, ELR weights as they are
    back = jax_tree_from_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                    weight_as_is(port))
    assert jax.tree.structure(back) == jax.tree.structure(dict(variables))
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, dict(variables))))
    ref = jax_answers(jm, variables, inputs, eps, monkeypatch, eval_only)
    out = port_answers(port, inputs, eps, eval_only)
    forms = [("eval", ref[0], out[0], EVAL_REL)]
    if not eval_only:
        forms.append(("train", ref[2], out[2], TRAIN_REL))
        assert_close(out[1], ref[1], GRAD_REL, "d kp / d image")
        stats = state_dict_from_jax(ref[3]) if ref[3] else {}
        bufs = dict(port.named_buffers())
        assert set(stats) == {k for k in bufs if k.endswith(("running_mean", "running_var"))}
        for k, r in stats.items():
            assert_close(bufs[k], r, STATS_REL, k)
    for what, r, o, rel in forms:
        r, o = _leaves(r), _leaves(o)
        assert len(r) == len(o) > 0, what
        for i, (a, b) in enumerate(zip(r, o)):
            assert_close(b, a, max(rel, kp_rel) if i == 0 else rel, f"{what} output {i}")


def _eps(variant, jcfg, N, rs):
    """The VAE's eps shape per variant (None: it does not sample)."""
    latent = {"conv4": 256, "conv5": (jcfg.model.image_size // 64) ** 2
              * jcfg.model.efe_down_seq[-1] // 2}.get(variant)
    return None if latent is None else rs.randn(N, latent).astype(np.float32)


CONV_128 = {"conv": {}, "conv2": {}, "conv5": {},
            "conv4": {"efe_down_seq": (3, 8, 16, 24, 32, 256)}}


@pytest.mark.parametrize("variant", sorted(CONV_128))
def test_conv_family_matches_jax(variant, monkeypatch):
    jcfg = model_config(jax_tiny_config(image_size=128), efe_variant=variant,
                        **CONV_128[variant])
    jm, variables, port, inputs = variant_case(jcfg, variant, 2, seed=11)
    eps = _eps(variant, jcfg, 2, np.random.RandomState(3))
    check_variant(jm, variables, port, inputs, eps, monkeypatch)


def test_elr_layers_and_embedder_match_jax():
    """Each ELR class (the conv and the linear demod and not, relu and
    leakyrelu), the NeRF embedding (log and even frequency spacing), against
    the JAX module on the same weights."""
    rs = np.random.RandomState(5)
    key = jax.random.PRNGKey(0)
    cases = []
    for norm, act in (("demod", "leakyrelu"), (None, "relu")):
        cases += [
            (jelr.Conv2dELR(4, 6, 3, 2, 1, norm=norm, act=act),
             elr.Conv2dELR(4, 6, 3, 2, 1, norm=norm, act=act), (2, 9, 9, 4)),
            (jelr.LinearELR(7, 5, lrmult=0.5, norm=norm, act=act),
             elr.LinearELR(7, 5, lrmult=0.5, norm=norm, act=act), (3, 7))]
    for d, cls, jcls, norm in ((1, elr.ConvTranspose1dELR, jelr.ConvTranspose1dELR, None),
                               (2, elr.ConvTranspose2dELR, jelr.ConvTranspose2dELR, "demod"),
                               (3, elr.ConvTranspose3dELR, jelr.ConvTranspose3dELR, "demod")):
        cases.append((jcls(3, 4, 4, 2, 1, norm=norm, act="leakyrelu"),
                      cls(3, 4, 4, 2, 1, norm=norm, act="leakyrelu"), (2,) + (5,) * d + (3,)))
    cases.append((jelr.UpSampleBlock3d(3, 2), elr.UpSampleBlock3d(3, 2), (1, 4, 4, 4, 3)))
    for jm, pm, shape in cases:
        x = rs.randn(*shape).astype(np.float32)
        args = (x,)
        if isinstance(pm, elr.UpSampleBlock3d):
            args = (x, rs.randn(1, 8, 8, 8, 2).astype(np.float32))
        variables = jax.tree.map(lambda a: rs.randn(*a.shape).astype(np.float32),
                                 jax.eval_shape(jm.init, key, *args))
        load_jax_variables(pm, variables)
        ref = np.asarray(jax.jit(jm.apply)(variables, *args))
        with torch.no_grad():
            out = pm(*(torch.from_numpy(a).movedim(-1, 1) if a.ndim > 2 else
                       torch.from_numpy(a) for a in args))
        out = out.movedim(1, -1) if out.dim() > 2 else out
        assert_close(out, ref, LAYER_REL, type(pm).__name__)
    for log_sampling, include in ((True, True), (False, False)):
        jfn, jdim = jax_get_embedder(6, include_input=include, log_sampling=log_sampling)
        fn, dim = get_embedder(6, include_input=include, log_sampling=log_sampling)
        kp = rs.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
        assert dim == jdim
        assert_close(fn(torch.from_numpy(kp)), np.asarray(jfn(kp)), LAYER_REL, "embedder")


def test_elr_init_draws():
    """The seeded init: N(0,1) weights (LinearELR / lrmult), zero biases, and
    the transposed convs' blockinit (k // stride draws, each repeated stride
    times along every spatial axis)."""
    g = torch.Generator().manual_seed(0)
    lin = elr.LinearELR(300, 200, lrmult=0.25)
    lin.init_parameters(g)
    assert abs(float(lin.weight.detach().std()) * 0.25 - 1) < 0.02 and not lin.bias.any()
    up = elr.ConvTranspose3dELR(5, 6, 4, 2, 1)
    up.init_parameters(g)
    w = up.weight
    assert torch.equal(w, w[:, :, ::2, ::2, ::2].repeat_interleave(2, 2)
                       .repeat_interleave(2, 3).repeat_interleave(2, 4))


def test_vaes_match_jax(monkeypatch):
    """FlattenVAE6 (conv6's, held here since conv6 runs only its eval form)
    and FlattenVAE, with and without sampling on one eps; LocalVAE in its
    training form (BatchNorm on batch statistics)."""
    from facevae_tpu.models import vae as jvae
    from facevae_tpu_torch.models import vae as pvae
    rs = np.random.RandomState(9)
    key = jax.random.PRNGKey(0)
    x = rs.randn(2, 4, 4, 16).astype(np.float32)
    eps = rs.randn(2, 256).astype(np.float32)
    monkeypatch.setattr("facevae_tpu.models.vae.jax", fixed_normal(eps))
    for jm, pm in ((jvae.FlattenVAE6(), pvae.FlattenVAE6()),
                   (jvae.FlattenVAE(down_seq=(256, 256)), pvae.FlattenVAE(down_seq=(256, 256)))):
        variables = fill(jax.eval_shape(lambda: jm.init({"params": key, "noise": key}, x)), rs)
        load_jax_variables(pm, variables)
        for train_vae in (False, True):
            ref = jax.jit(lambda v, t: jm.apply(v, t, train_vae, rngs={"noise": key}))(
                variables, x)
            with torch.no_grad():
                out = pm(torch.from_numpy(x).movedim(-1, 1), train_vae, torch.from_numpy(eps))
            assert len(_leaves(ref)) == len(_leaves(out)) > 0
            for i, (r, o) in enumerate(zip(_leaves(ref), _leaves(out))):
                o = o.movedim(1, -1) if o.dim() == 4 else o
                assert_close(o, np.asarray(r), EVAL_REL, f"{type(pm).__name__} {train_vae} {i}")
    jm = jvae.LocalVAE()
    pm = pvae.LocalVAE(16, 4)
    variables = fill(jax.eval_shape(lambda: jm.init({"params": key}, x)), rs)
    load_jax_variables(pm.train(), variables)
    (_, ref), upd = jax.jit(lambda v, t: jm.apply(v, t, True, mutable=["batch_stats"]))(
        variables, x)
    with torch.no_grad():
        _, out = pm(torch.from_numpy(x).movedim(-1, 1))
    assert_close(out.movedim(1, -1), np.asarray(ref), TRAIN_REL, "LocalVAE")
    bufs = dict(pm.named_buffers())
    for k, r in state_dict_from_jax(jax.tree.map(np.asarray, upd)).items():
        assert_close(bufs[k], r, STATS_REL, k)


def test_drive_graph_of_a_variant_matches_jax():
    """conv at 128x128 (narrow widths) behind the port's InferencePipeline
    against the JAX package's: drive_batch on the port's encode_source of
    one source (its EFE runs on each driving frame), 1e-4 of max|ref|
    (tests/test_torch_pipeline.py's tolerance)."""
    from facevae_tpu_torch.train.inference import InferencePipeline
    jcfg = model_config(jax_tiny_config(image_size=128), efe_variant="conv")
    variables = golden.g_variables(jcfg, seed=7)
    pcfg = model_config(tiny_config(image_size=128), efe_variant="conv")
    nets = build_models(pcfg.model, device="cpu")
    for name, net in nets.items():
        load_jax_variables(net, variables[name])
    port, ref = InferencePipeline(pcfg, nets), golden.jax_pipeline(jcfg, variables)
    rs = np.random.RandomState(12)
    s, d = (rs.rand(2, 128, 128, 3).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        enc = port.encode_source(torch.from_numpy(s[:1]))
        out = port.drive_batch(*enc, torch.from_numpy(d))
    ref_out = ref.drive_batch(*(e.numpy() for e in enc), d)
    assert_close(out, np.asarray(ref_out), EVAL_REL, "drive_batch")


def test_linear_variant_epoch_file_both_ways(tmp_path):
    """A train state of efe_variant="linear" (256x256; the other nets at
    tiny widths) with seeded Adam moments, written by the JAX package: the
    port loads every leaf bit for bit (the EFE's ELR weights as they are,
    its Adam moments by name) and writes it back; the JAX package reads
    that file into the tree it wrote."""
    import flax.serialization
    import optax
    from facevae_tpu import train as jtrain
    from facevae_tpu.train import state as jtrain_state
    from facevae_tpu_torch.convert import net_variables
    from facevae_tpu_torch.train import checkpoint as ckpt
    from facevae_tpu_torch.train import create_train_state

    jcfg = model_config(jax_tiny_config(image_size=256), efe_variant="linear")
    _, variables = golden.train_variables(jcfg, seed=17)
    draws = np.random.default_rng(2)

    def adam(names):
        """optax.adam's state at count 3 with seeded moments (numpy)."""
        params = {n: variables[n]["params"] for n in names}
        mu, nu = (jax.tree.map(lambda a: np.abs(draws.standard_normal(a.shape, np.float32)),
                               params) for _ in range(2))
        return (optax.ScaleByAdamState(count=np.asarray(3, np.int32), mu=mu, nu=nu),
                optax.EmptyState())
    jstate = jtrain_state.TrainState(
        g_params={n: variables[n]["params"] for n in jtrain_state.G_MODEL_NAMES},
        d_params={n: variables[n]["params"] for n in jtrain_state.D_MODEL_NAMES},
        c_params={"contrastive": variables["contrastive"]["params"]},
        teachers={n: variables[n] for n in ("hopenet", "perceptual")},
        batch_stats={n: v["batch_stats"] for n, v in variables.items()
                     if "batch_stats" in v and n not in ("hopenet", "perceptual")},
        spectral={n: v["spectral"] for n, v in variables.items() if "spectral" in v},
        g_opt=adam(jtrain_state.G_MODEL_NAMES), d_opt=adam(jtrain_state.D_MODEL_NAMES),
        epoch=np.asarray(2, np.int32), step=np.asarray(9, np.int32))
    tree = jax.tree.map(np.asarray, flax.serialization.to_state_dict(jstate))
    jtrain.save_checkpoint(str(tmp_path / "jax"), jstate, 2)

    state = ckpt.load_checkpoint(str(tmp_path / "jax"), 2, create_train_state(
        model_config(tiny_config(image_size=256), efe_variant="linear"), "cpu"))
    assert (state.epoch, state.step) == (2, 9)
    ref = state_dict_from_jax(net_variables(tree, "efe"))
    assert any(k.endswith("final_linear.weight") for k in ref)
    for k, v in state.nets["efe"].state_dict().items():
        assert np.array_equal(v.numpy(), ref[k]), k
    mu = state_dict_from_jax({"params": tree["g_opt"]["0"]["mu"]["efe"]})
    for k, p in state.nets["efe"].named_parameters():
        assert np.array_equal(state.g_opt.state[p]["exp_avg"].numpy(), mu[k]), k

    ckpt.save_checkpoint(str(tmp_path / "port"), state, 2)
    back = jax.tree.map(np.asarray, flax.serialization.to_state_dict(
        jtrain.load_checkpoint(str(tmp_path / "port"), 2, jstate)))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, tree)))
