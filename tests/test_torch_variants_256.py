"""PyTorch port: the EFE variants that build at 256x256 only (conv3 with
LocalVAE, conv6 with FlattenVAE6 and its ELR encoder / decoder, linear and
lin_conv with their ELR stacks and the keypoint embedding), batch 1, each
against facevae_tpu's module on bridged weights as
tests/test_torch_variants.py holds the conv family (its tolerances; the
eval form with the input gradient, the training form with VAE sampling on
one eps; conv6 in the eval form only, against the JAX module's answer
recorded by tests/make_torch_variant_golden.py); and the configurations
both packages refuse.

Widths: conv3 narrow (tiny_config(image_size=256), an up stack of two
blocks); conv6's are hard-coded (D = 16, which its decoder's depth
doubling needs); linear and lin_conv take their constructor defaults from
the factory, whatever the config (lin_conv's 4096-wide linears included).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.models import build_models as jax_build_models
from facevae_tpu.train.state import build_all_modules as jax_build_all_modules
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.train import create_train_state
from facevae_tpu_torch.convert import jax_tree_from_state_dict, weight_as_is
from make_torch_variant_golden import GOLDEN, OUTPUTS, conv6_case, digest
from test_torch_variants import EVAL_REL, check_variant, model_config, variant_case
from torch_parity import assert_close, one_torch_thread  # noqa: F401

# variant -> (ModelConfig changes, the VAE's latent width or None)
CASES = {"conv3": ({"efe_up_seq": (32, 16, 8)}, None), "linear": ({}, None),
         "lin_conv": ({}, 2048)}
# conv6's keypoints: the port's CPU softmax sums its (256, 64, 64) volume in
# fp32 one term after another (5e-4 of the heatmap's largest value off the
# float64 answer; XLA sums in a tree, 1e-6), while every layer before it
# agrees with the JAX module to 1e-8 in float64: measured 1.5e-3 of max|kp|
CONV6_KP_REL = 3e-3


@pytest.mark.parametrize("variant", sorted(CASES))
def test_variant_matches_jax_at_256(variant, monkeypatch):
    kw, latent = CASES[variant]
    jcfg = model_config(jax_tiny_config(image_size=256), efe_variant=variant, **kw)
    jm, variables, port, inputs = variant_case(jcfg, variant, 1, seed=13)
    eps = None if latent is None else np.random.RandomState(4).randn(1, latent).astype(
        np.float32)
    check_variant(jm, variables, port, inputs, eps, monkeypatch)


def test_conv6_matches_jax():
    """conv6 in the eval form, against the JAX module's answer recorded in
    tests/data/torch_conv6_golden.npz by tests/make_torch_variant_golden.py
    on the same numpy-seeded weights and inputs (their digest must match):
    one JAX forward takes ~20 s and ~200 CPU-seconds (its transposed convs
    run as input-dilated convs, 8x the work).  Its FlattenVAE6 sampling is
    held in test_torch_variants.py::test_vaes_match_jax."""
    z = np.load(GOLDEN)
    jm, variables, port, inputs = conv6_case()
    assert str(z["digest"]) == digest(variables, inputs), \
        "the golden's weights or inputs differ: rerun tests/make_torch_variant_golden.py"
    back = jax_tree_from_state_dict({k: v.numpy() for k, v in port.state_dict().items()},
                                    weight_as_is(port))
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, dict(variables))))
    x, x_a, kp, _ = (torch.from_numpy(a) for a in inputs)
    with torch.no_grad():
        kp_, x_c, x_a_c, (mu, logstd), (x_vae, x_hat) = port.eval()(x, x_a, kp)
    for name, out in zip(OUTPUTS, (kp_, x_c, x_a_c, mu, logstd, x_vae, x_hat)):
        assert_close(out, z[name], CONV6_KP_REL if name == "kp" else EVAL_REL, name)


def _jax_error(fn):
    """The name of the exception fn() raises, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001 - whatever the trace raises
        return type(e).__name__
    return None


def _jax_efe_init(cfg, key):
    m = jax_build_models(cfg.model)["efe"]
    size, K = cfg.model.image_size, cfg.model.num_kp
    img, kp = jnp.zeros((1, size, size, 3)), jnp.zeros((1, K, 3))
    return m, lambda: jax.eval_shape(
        lambda: m.init({"params": key, "noise": key}, img, img, kp))


def test_both_packages_refuse_the_same_configurations():
    """Both packages refuse to build conv4 at the default widths (FlattenVAE's
    latent of 256 into the encoder map's C*h*w = 2*2*32) and conv6 off
    256x256; and to train conv2 and conv6, whose x_c the contrastive head,
    built at conv5's width, cannot take.  The JAX step fails there at the
    head's call (ScopeParamShapeError at projection/proj_fc1), which is
    traced here on the head as the JAX state initializes it and on the
    variant's own x_c (a trace of the whole JAX step takes ~10 s a variant); the port refuses at state
    creation.  linear, with no x_c, builds a state in the port."""
    key = jax.random.PRNGKey(0)
    for variant, size, kw in (("conv4", 256, {"efe_down_seq": (3, 32, 64, 128, 256, 32)}),
                              ("conv6", 128, {"depth": 16})):
        jcfg = model_config(jax_tiny_config(image_size=size), efe_variant=variant, **kw)
        assert _jax_error(_jax_efe_init(jcfg, key)[1]) is not None, variant
        pcfg = model_config(tiny_config(image_size=size), efe_variant=variant, **kw)
        with pytest.raises(ValueError, match="unflatten|hard-codes"):
            build_models(pcfg.model, "cpu", names=("efe",))
    for variant, kw in (("conv2", {}), ("conv6", {"depth": 16})):
        jcfg = model_config(jax_tiny_config(image_size=256), efe_variant=variant, **kw)
        efe, init = _jax_efe_init(jcfg, key)
        img = jnp.zeros((2, 256, 256, 3))
        x_c = jax.eval_shape(lambda v: efe.apply(v, img, img, jnp.zeros((2, 5, 3)),
                                                 train=False)[1], init())
        # the head as the JAX state initializes it (facevae_tpu/train/state.py)
        m = jcfg.model
        feat = jnp.zeros((2, (m.image_size // 64) ** 2 * m.efe_down_seq[-1]))
        head = jax_build_all_modules(jcfg)["contrastive"]
        head_vars = jax.eval_shape(lambda: head.init(key, feat, feat))
        assert _jax_error(lambda: jax.eval_shape(
            lambda v: head.apply(v, jnp.zeros(x_c.shape), jnp.zeros(x_c.shape), train=True,
                                 mutable=["batch_stats"]), head_vars)) \
            == "ScopeParamShapeError", variant
        pcfg = model_config(tiny_config(image_size=256), efe_variant=variant, **kw)
        with pytest.raises(ValueError, match="contrastive features x_c of width"):
            create_train_state(pcfg, "cpu")
    create_train_state(model_config(tiny_config(image_size=256), efe_variant="linear"), "cpu")
