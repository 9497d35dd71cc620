"""PyTorch port: each serving-path net against facevae_tpu's, on weights
bridged by facevae_tpu_torch.convert, at tiny_config() and batch 2 on the
CPU; and the bridge's strictness.

Tolerance: max|err| <= 1e-4 * max|ref| per output.  Both sides are fp32; they
differ in convolution algorithms and summation order (~1e-6 relative per
layer), which the 0.1-temperature soft-argmax of the keypoint heads
amplifies ~10x.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config
from facevae_tpu.models import build_models as build_jax_models
from facevae_tpu.ops.geometry import make_coordinate_grid_3d, pose_rotation
from facevae_tpu_torch.convert import load_jax_variables, natural_key, state_dict_from_jax
from facevae_tpu_torch.models import build_models
from torch_parity import assert_close, golden, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast
REL = 1e-4


@pytest.fixture(scope="module")
def env():
    cfg = tiny_config()
    m = cfg.model
    variables = golden.g_variables(cfg, seed=3)
    jmodels = build_jax_models(m)
    tmodels = build_models(m)
    for name, model in tmodels.items():
        load_jax_variables(model, variables[name])
    rs = np.random.RandomState(7)
    N, K, hq = 2, m.num_kp, m.image_size // 4
    img = rs.rand(N, m.image_size, m.image_size, 3).astype(np.float32)
    kp = [rs.uniform(-0.6, 0.6, (N, K, 3)).astype(np.float32) for _ in range(3)]
    R = [np.asarray(pose_rotation(*[rs.uniform(-0.5, 0.5, N).astype(np.float32)
                                    for _ in range(3)])) for _ in range(2)]
    fs = (0.5 * rs.randn(N, m.depth, hq, hq, m.app_channels)).astype(np.float32)
    grid = np.asarray(make_coordinate_grid_3d((m.depth, hq, hq)))
    deformation = (grid[None] + rs.normal(0, 0.1, (N, m.depth, hq, hq, 3))).astype(np.float32)
    occlusion = rs.rand(N, hq, hq, 1).astype(np.float32)
    inputs = {"afe": (img,), "ckd": (img,), "hpe_ede": (img,), "efe": (img, None, kp[0]),
              "mfe": (fs, kp[1], kp[2], R[0], R[1]),
              "generator": (fs, deformation, occlusion)}
    return dict(cfg=cfg, variables=variables, jmodels=jmodels, tmodels=tmodels,
                inputs=inputs)


def _outputs(out):
    """The numeric outputs, flattened (EFE's Nones dropped)."""
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _outputs(x)]
    return [] if out is None else [out]


@pytest.mark.parametrize("name", ["afe", "ckd", "hpe_ede", "efe", "mfe", "generator"])
def test_model_matches_jax(env, name):
    args = env["inputs"][name]
    jmodel = env["jmodels"][name]
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, train=False))(
        env["variables"][name], *[None if a is None else jnp.asarray(a) for a in args])
    with torch.inference_mode():            # the port is forward-only so far
        port = env["tmodels"][name](*[None if a is None else torch.from_numpy(np.array(a))
                                      for a in args])
    ref, port = _outputs(ref), _outputs(port)
    assert len(ref) == len(port) > 0
    for i, (p, r) in enumerate(zip(port, ref)):
        assert_close(p, np.asarray(r), REL, f"{name} output {i}")


def _mutate(variables, how):
    v = copy.deepcopy(variables)
    conv = v["params"]["in_conv"]["Conv_0"]
    if how == "missing":
        del conv["bias"]
    elif how == "extra":
        conv["extra"] = np.zeros(3, np.float32)
    elif how == "unused":
        v["params"]["ghost_0"] = {"kernel": np.zeros((3, 3, 4, 4), np.float32)}
    elif how == "shape":
        conv["bias"] = np.zeros(conv["bias"].shape[0] + 1, np.float32)
    elif how == "collection":
        v["cache"] = {}
    return v


@pytest.mark.parametrize("how, match", [("missing", "no JAX leaf"),
                                        ("extra", "unmapped JAX leaf"),
                                        ("unused", "no parameter"),
                                        ("shape", "shape"),
                                        ("collection", "collections")])
def test_bridge_is_strict(env, how, match):
    model = build_models(env["cfg"].model, names=("generator",))["generator"]
    with pytest.raises(ValueError, match=match):
        load_jax_variables(model, _mutate(env["variables"]["generator"], how))


def test_bridge_maps_by_name(env):
    """Natural order (Conv_10 after Conv_9), and the spectral v permutation:
    sigma = u^T W v must be the same number in both layouts."""
    assert sorted(["Conv_10", "Conv_9", "Conv_1"], key=natural_key) == \
        ["Conv_1", "Conv_9", "Conv_10"]
    var = env["variables"]["generator"]
    sd = state_dict_from_jax(var)
    jconv, jspec = var["params"]["in_conv"]["Conv_0"], var["spectral"]["in_conv"]["Conv_0"]
    w_jax = jconv["kernel"].reshape(-1, jconv["kernel"].shape[-1]).T
    sigma_jax = jspec["u"] @ w_jax @ jspec["v"]
    w = sd["in_conv.Conv_0.weight"]
    sigma = sd["in_conv.Conv_0.weight_u"] @ w.reshape(w.shape[0], -1) @ sd["in_conv.Conv_0.weight_v"]
    np.testing.assert_allclose(sigma, sigma_jax, rtol=1e-5)


def test_build_models_refuses_what_is_not_ported(env):
    """The dormant EFE variants and VAE sampling are not ported; unknown
    names are refused; the discriminator and the training forms are."""
    with pytest.raises(NotImplementedError):
        build_models(dataclasses.replace(env["cfg"].model, efe_variant="conv4"),
                     names=("efe",))
    with pytest.raises(ValueError, match="unknown"):
        build_models(env["cfg"].model, names=("hopenet",))
    efe = build_models(env["cfg"].model, names=("efe",))["efe"]
    img, _, kp = env["inputs"]["efe"]
    with pytest.raises(NotImplementedError, match="train_vae"):
        efe(torch.from_numpy(img), None, torch.from_numpy(kp), train_vae=True)
    nets = build_models(env["cfg"].model, names=("generator", "discriminator"))
    out = nets["generator"].train()(*[torch.from_numpy(a) for a in env["inputs"]["generator"]])
    logits, features = nets["discriminator"].train()(out, torch.from_numpy(kp))
    assert logits.shape[-1] == 1 and len(features) == 4


@pytest.mark.parametrize("pattern, norm, act, sn, dim", [
    ("CNA", "batch", "relu", False, 2),
    ("NAC", "instance", "leakyrelu", False, 2),
    ("CNA", "batch", "leakyrelu", True, 2),
    ("CN", "none", "relu", True, 3),
    ("NAC", "batch", "relu", False, 3),
])
def test_conv_block_matches_jax(pattern, norm, act, sn, dim):
    """nn layers one by one: Conv (+ spectral norm from stored u, v),
    BatchNorm eval fold, InstanceNorm, the activations, 2D and 3D."""
    from facevae_tpu.nn import ConvBlock as JaxConvBlock
    from facevae_tpu_torch.nn import ConvBlock
    rs = np.random.RandomState(13)
    x = rs.randn(2, *(4,) * (dim - 2), 8, 6, 5).astype(np.float32)      # channel-last
    jblock = JaxConvBlock(pattern, 5, 7, 3, 1, 1, sn, dim=dim, norm_type=norm,
                          nonlinearity_type=act)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables = golden.fill_variables(dict(shapes), rs)
    ref = jblock.apply(variables, jnp.asarray(x), train=False)
    block = load_jax_variables(ConvBlock(pattern, 5, 7, 3, 1, 1, sn, dim=dim, norm_type=norm,
                                         nonlinearity_type=act).eval(), variables)
    perm = (0, dim + 1) + tuple(range(1, dim + 1))
    with torch.inference_mode():
        port = block(torch.from_numpy(x).permute(perm)).permute(0, *range(2, dim + 2), 1)
    assert_close(port, np.asarray(ref), 1e-5, f"{pattern} {norm} {act} sn={sn} {dim}D")
