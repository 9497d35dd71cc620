"""PyTorch port: the training forms of the layers, the losses, the nets of
the training step and the ops of its objective against facevae_tpu's, on
the CPU with the same numpy inputs and weights (JAX variable shapes from
jax.eval_shape, values from tools/make_torch_golden.py:fill_variables,
bridged by facevae_tpu_torch.convert).

Tolerances, relative to max|ref| of each output: 1e-5 for single layers and
pure ops (fp32 sums in another order); 1e-4 for whole nets and the
perceptual loss (a few layers of such differences, as in
tests/test_torch_models.py).  The perceptual loss's input gradient is held
to the JAX package's within 10x the change that nudging the input by 2^-20
(a few fp32 ulps) makes in the JAX gradient, plus 1e-4 (its L1 terms have
gradient sign(a - b), which rounding flips where a deep feature of the
image and of the target nearly coincide).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.losses import (ContrastiveHead as JaxContrastiveHead,
                                PerceptualLoss as JaxPerceptualLoss)
from facevae_tpu.losses import gan as jgan, keypoint as jkp, vae_losses as jvae
from facevae_tpu.models.discriminator import Discriminator as JaxDiscriminator
from facevae_tpu.models.efe import EFEConv as JaxEFE
from facevae_tpu.models.hopenet import Hopenet as JaxHopenet
from facevae_tpu.nn import BatchNorm as JaxBatchNorm, Conv as JaxConv
from facevae_tpu.ops import heatmap as jh, interpolate as ji, normalization as jn, tps as jt
from facevae_tpu.ops.geometry import make_coordinate_grid_2d
from facevae_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from facevae_tpu_torch.losses import ContrastiveHead, PerceptualLoss
from facevae_tpu_torch.losses import gan as tgan, keypoint as tkp, vae_losses as tvae
from facevae_tpu_torch.models import Discriminator, EFEConv, Hopenet
from facevae_tpu_torch.nn import BatchNorm, Conv
from facevae_tpu_torch.ops import heatmap as th, interpolate as ti, normalization as tn, tps as tt
from torch_parity import assert_close, assert_held, golden, one_torch_thread  # noqa: F401

LAYER = 1e-5
NET = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def _vars(module, *args, rs, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return golden.fill_variables(dict(shapes), rs)


def _nchw(a):
    return T(a).permute(0, a.ndim - 1, *range(1, a.ndim - 1))


def _cl(t):
    return t.permute(0, *range(2, t.dim()), 1)


# -- training forms of the layers --------------------------------------------

@pytest.mark.parametrize("shape, affine", [((6, 7), True), ((3, 5, 4, 7), True),
                                           ((2, 3, 4, 5, 7), True), ((6, 7), False)])
def test_batchnorm_training_form(rng, shape, affine):
    """Output, running mean and (unbiased, momentum 0.1) running variance
    after two training calls, and the gradient of the input."""
    x1, x2 = ((rng.randn(*shape) * 2 + 1).astype(np.float32) for _ in range(2))
    cot = rng.randn(*shape).astype(np.float32)
    jbn = JaxBatchNorm(7, use_scale_bias=affine)
    v = _vars(jbn, jnp.asarray(x1), rs=rng)

    def jax_apply(variables, xs):
        outs = []
        for x in xs:
            y, upd = jbn.apply(variables, x, train=True, mutable=["batch_stats"])
            variables = {**variables, **upd}
            outs.append(y)
        return outs, variables["batch_stats"]

    (y1, y2), stats = jax_apply(v, (jnp.asarray(x1), jnp.asarray(x2)))
    gx = jax.grad(lambda x: jnp.sum(jax_apply(v, (x,))[0][0] * cot))(jnp.asarray(x1))
    bn = load_jax_variables(BatchNorm(7, affine=affine), v).train()
    xt = _nchw(x1).requires_grad_()
    out1 = bn(xt)
    (out1 * _nchw(cot)).sum().backward()
    out2 = bn(_nchw(x2))
    assert_close(_cl(out1), y1, LAYER, "first output")
    assert_close(_cl(out2), y2, LAYER, "second output")
    assert_close(_cl(xt.grad), gx, LAYER, "dx")
    assert_close(bn.running_mean, stats["mean"], LAYER, "running mean")
    assert_close(bn.running_var, stats["var"], LAYER, "running var")


@pytest.mark.parametrize("dim", [2, 3])
def test_spectral_norm_power_iteration(rng, dim):
    """One power iteration per training call: the output and u, v after one
    and after two calls, and the weight gradient (through W only)."""
    x = rng.randn(2, *(5,) * dim, 4).astype(np.float32)
    cot_shape = (2, *(5,) * dim, 6)
    cot = rng.randn(*cot_shape).astype(np.float32)
    jconv = JaxConv(6, 3, 1, 1, dim=dim, use_spectral_norm=True)
    v = _vars(jconv, jnp.asarray(x), rs=rng)
    conv = load_jax_variables(Conv(4, 6, 3, 1, 1, dim=dim, spectral_norm=True), v).train()
    variables = v
    for call in range(2):
        def f(params, variables=variables):
            y, upd = jconv.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                 mutable=["spectral"])
            return jnp.sum(y * cot), (y, upd)

        (_, (y, upd)), g = jax.value_and_grad(f, has_aux=True)(variables["params"])
        variables = {**variables, **upd}
        conv.zero_grad()
        out = conv(_nchw(x))
        (out * _nchw(cot)).sum().backward()
        ref = state_dict_from_jax({"params": g, "spectral": upd["spectral"]})
        assert_close(_cl(out), y, LAYER, f"output, call {call + 1}")
        assert_close(conv.weight.grad, ref["weight"], LAYER, f"dW, call {call + 1}")
        assert_close(conv.weight_u, ref["weight_u"], LAYER, f"u, call {call + 1}")
        assert_close(conv.weight_v, ref["weight_v"], LAYER, f"v, call {call + 1}")


# -- losses -------------------------------------------------------------------

def test_pure_losses(rng):
    """GAN hinge, feature matching, keypoint, headpose, deformation prior,
    KL and reconstruction losses, values and input gradients."""
    logits = rng.randn(3, 4, 4, 1).astype(np.float32)
    feats = [rng.randn(3, 5, 5, c).astype(np.float32) for c in (4, 6)]
    reals = [rng.randn(3, 5, 5, c).astype(np.float32) for c in (4, 6)]
    kp = rng.uniform(-0.6, 0.6, (3, 5, 3)).astype(np.float32)
    rev = rng.uniform(-0.6, 0.6, (3, 5, 2)).astype(np.float32)
    angles = [rng.uniform(-1, 1, 9).astype(np.float32) for _ in range(6)]
    mu, logstd = (rng.randn(3, 8).astype(np.float32) * 0.5 for _ in range(2))
    a, b = (rng.rand(3, 6, 6, 3).astype(np.float32) for _ in range(2))
    cases = [
        (lambda x: tgan.gan_loss_dis(x, True), lambda x: jgan.gan_loss_dis(x, True), logits),
        (lambda x: tgan.gan_loss_dis(x, False), lambda x: jgan.gan_loss_dis(x, False), logits),
        (tgan.gan_loss_gen, jgan.gan_loss_gen, logits),
        (lambda f: tgan.feature_matching_loss([f, T(feats[1])], [T(r) for r in reals]),
         lambda f: jgan.feature_matching_loss([f, feats[1]], reals), feats[0]),
        (lambda k: tkp.equivariance_loss(k, T(rev)), lambda k: jkp.equivariance_loss(k, rev), kp),
        (tkp.keypoint_prior_loss, jkp.keypoint_prior_loss, kp),
        (tkp.deformation_prior_loss, jkp.deformation_prior_loss, kp),
        (lambda y: tkp.headpose_loss(y, *map(T, angles[1:])),
         lambda y: jkp.headpose_loss(y, *angles[1:]), angles[0]),
        (lambda m: tvae.kl_divergence_loss(m, T(logstd)),
         lambda m: jvae.kl_divergence_loss(m, logstd), mu),
        (lambda x: tvae.recon_loss(T(a), x), lambda x: jvae.recon_loss(a, x), b),
    ]
    for i, (port_fn, jax_fn, x) in enumerate(cases):
        xt = T(x).requires_grad_()
        port = port_fn(xt)
        port.backward()
        ref, grad = jax.value_and_grad(jax_fn)(jnp.asarray(x))
        assert_close(port, ref, LAYER, f"loss {i}")
        assert_close(xt.grad, grad, LAYER, f"loss {i} gradient")


@pytest.mark.parametrize("size, n_scales, fixed", [(64, 1, False), (128, 2, False),
                                                   (64, 1, True)])
def test_perceptual_loss(rng, size, n_scales, fixed):
    """VGG19 + VGG-Face truncated at relu_5_1, the q3 pyramid by default;
    the loss and its gradient in the generated image."""
    inp, tgt = (rng.rand(2, size, size, 3).astype(np.float32) for _ in range(2))
    jloss = JaxPerceptualLoss(n_scales=n_scales, fixed_pyramid=fixed)
    v = _vars(jloss, jnp.asarray(inp), jnp.asarray(tgt), rs=rng)
    vg = jax.jit(jax.value_and_grad(lambda x: jloss.apply(v, x, jnp.asarray(tgt))))
    ref, grad = vg(jnp.asarray(inp))
    _, grad_nudged = vg(jnp.asarray(inp * (1 + 2.0 ** -20 * rng.randn(*inp.shape))
                                    .astype(np.float32)))
    loss = load_jax_variables(PerceptualLoss(n_scales, fixed), v)
    xt = T(inp).requires_grad_()
    port = loss(xt, T(tgt))
    port.backward()
    assert_close(port, ref, NET, "perceptual loss")
    assert_held(xt.grad, grad, [grad_nudged], NET, "perceptual gradient")


def test_contrastive_head_flattens_channel_last(rng):
    """The SimSiam head on [N,2,2,C] channel-last maps, where the flatten
    order shows: loss, BN statistics after the two projector and predictor
    calls, and the gradients of both views."""
    f1, f2 = (rng.randn(4, 2, 2, 6).astype(np.float32) for _ in range(2))
    jhead = JaxContrastiveHead(hid_dim=16, out_dim=8)
    flat = [jnp.asarray(f.reshape(4, -1)) for f in (f1, f2)]
    v = _vars(jhead, *flat, rs=rng)

    def f(a, b):
        loss, upd = jhead.apply(v, a, b, mutable=["batch_stats"])
        return loss, upd

    (ref, upd), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(f1), jnp.asarray(f2))
    head = load_jax_variables(ContrastiveHead(24, hid_dim=16, out_dim=8), v).train()
    t1, t2 = (T(a).requires_grad_() for a in (f1, f2))
    port = head(t1, t2)
    port.backward()
    assert_close(port, ref, LAYER, "loss")
    assert_close(t1.grad, grads[0], LAYER, "d view 1")
    assert_close(t2.grad, grads[1], LAYER, "d view 2")
    stats = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
    bufs = dict(head.named_buffers())
    assert set(stats) == set(bufs)
    for k, s in stats.items():
        assert_close(bufs[k], s, LAYER, k)


# -- nets of the training step -------------------------------------------------

def test_discriminator_two_training_calls(rng):
    """Logits and features of a real and a fake batch in training mode
    (spectral u, v advance per call), the hinge gradient of every
    parameter, and u, v after the two calls."""
    K = 3
    x1, x2 = (rng.rand(2, 32, 32, 3).astype(np.float32) for _ in range(2))
    kp = rng.uniform(-0.8, 0.8, (2, K, 3)).astype(np.float32)
    jd = JaxDiscriminator(down_seq=(8, 16, 16, 32), K=K)
    v = _vars(jd, jnp.asarray(x1), jnp.asarray(kp), rs=rng)

    def f(params):
        (o1, f1), up = jd.apply({**v, "params": params}, jnp.asarray(x1), jnp.asarray(kp),
                                mutable=["spectral"])
        (o2, _), up = jd.apply({"params": params, **up}, jnp.asarray(x2), jnp.asarray(kp),
                               mutable=["spectral"])
        loss = jgan.gan_loss_dis(o1, True) + jgan.gan_loss_dis(o2, False)
        return loss, (o1, f1, o2, up)

    (_, (o1, f1, o2, up)), g = jax.value_and_grad(f, has_aux=True)(v["params"])
    disc = load_jax_variables(Discriminator((8, 16, 16, 32), K=K), v).train()
    p1, pf1 = disc(T(x1), T(kp))
    p2, _ = disc(T(x2), T(kp))
    (tgan.gan_loss_dis(p1, True) + tgan.gan_loss_dis(p2, False)).backward()
    assert_close(p1, o1, NET, "real logits")
    assert_close(p2, o2, NET, "fake logits")
    for i, (a, b) in enumerate(zip(pf1, f1)):
        assert_close(a, b, NET, f"feature {i}")
    ref = state_dict_from_jax({"params": g, "spectral": up["spectral"]})
    params, bufs = dict(disc.named_parameters()), dict(disc.named_buffers())
    top = max(float(np.abs(r).max()) for k, r in ref.items() if k in params)
    for k, r in ref.items():
        if k in params:     # a conv bias feeding an instance norm has gradient 0
            assert_close(params[k].grad, r, NET, k) if np.abs(r).max() > 1e-4 * top else \
                np.testing.assert_allclose(params[k].grad.numpy(), r, atol=1e-4 * top)
        else:
            assert_close(bufs[k], r, NET, k)


def test_hopenet_teacher(rng):
    """The frozen ResNet-50 pose teacher, eval form whatever train() says."""
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    jnet = JaxHopenet()
    v = _vars(jnet, jnp.asarray(x), rs=rng)
    ref = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(v, jnp.asarray(x))
    net = load_jax_variables(Hopenet(), v).train()
    assert not net.training and not any(p.requires_grad for p in net.parameters())
    with torch.no_grad():
        port = net(T(x))
    for name, p, r in zip(("yaw", "pitch", "roll"), port, ref):
        assert_close(p, r, NET, name)


def test_efe_contrastive_branch(rng):
    """EFE with the augmented view at 128x128 (a 2x2 encoder map): kp and
    the two channel-last encoder maps in training mode, and the BN
    statistics the three encoder passes leave."""
    widths = dict(down_seq=(3, 8, 8, 8, 8, 12), up_seq=(8, 8, 8, 8, 8, 8), D=4, K=3,
                  n_res=1)
    x, xa = (rng.rand(2, 128, 128, 3).astype(np.float32) for _ in range(2))
    kp = rng.uniform(-0.5, 0.5, (2, 3, 3)).astype(np.float32)
    jefe = JaxEFE(**widths)
    v = _vars(jefe, jnp.asarray(x), jnp.asarray(xa), jnp.asarray(kp), rs=rng)
    (rkp, rxc, rxac, _, _), upd = jefe.apply(v, jnp.asarray(x), jnp.asarray(xa), jnp.asarray(kp),
                                             mutable=["batch_stats"])
    efe = load_jax_variables(EFEConv(**widths), v).train()
    with torch.no_grad():
        pkp, pxc, pxac, _, _ = efe(T(x), T(xa), T(kp))
    assert pxc.shape == (2, 2, 2, 12) and pxac.shape == pxc.shape
    assert_close(pkp, rkp, NET, "kp")
    assert_close(pxc, rxc, NET, "x_c")
    assert_close(pxac, rxac, NET, "x_a_c")
    stats = state_dict_from_jax({"batch_stats": upd["batch_stats"]})
    bufs = dict(efe.named_buffers())
    for k, s in stats.items():
        assert_close(bufs[k], s, NET, k)


# -- ops of the objective ---------------------------------------------------------

def test_normalization_and_resizes(rng):
    x = rng.rand(2, 64, 64, 3).astype(np.float32)
    assert_close(tn.apply_imagenet_normalization(T(x)), jn.apply_imagenet_normalization(x),
                 LAYER, "imagenet")
    assert_close(tn.apply_vggface_normalization(T(x)), jn.apply_vggface_normalization(x),
                 LAYER, "vggface")
    for hw in ((224, 224), (40, 24)):
        assert_close(_cl(ti.interpolate_nearest_2d(_nchw(x), hw)),
                     ji.interpolate_nearest_2d(jnp.asarray(x), hw), LAYER, f"nearest {hw}")
    assert_close(_cl(ti.resize_bilinear_half(_nchw(x))), ji.resize_bilinear_half(jnp.asarray(x)),
                 LAYER, "bilinear half")


def test_kp2gaussian_2d(rng):
    kp = rng.uniform(-1, 1, (2, 4, 2)).astype(np.float32)
    assert_close(th.kp2gaussian_2d_cl(T(kp), (9, 7)), jh.kp2gaussian_2d_cl(kp, (9, 7)),
                 LAYER, "kp2gaussian_2d")


def test_tps_warp(rng):
    """warp_coordinates and transform_frame (reflection padding, reaching
    past the border) from the same parameters; random_transform_params'
    layout and scale."""
    N = 3
    theta = (np.eye(2, 3)[None] + 0.3 * rng.randn(N, 2, 3)).astype(np.float32)
    cp = np.asarray(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2)
    cparams = (0.05 * rng.randn(N, 1, 25)).astype(np.float32)
    jtp = jt.TransformParams(jnp.asarray(theta), jnp.asarray(cp), jnp.asarray(cparams))
    ttp = tt.TransformParams(T(theta), T(cp), T(cparams))
    coords = rng.uniform(-1, 1, (N, 7, 2)).astype(np.float32)
    assert_close(tt.warp_coordinates(ttp, T(coords)), jt.warp_coordinates(jtp, coords),
                 LAYER, "warp_coordinates")
    frame = rng.rand(N, 16, 12, 3).astype(np.float32)
    assert_close(tt.transform_frame(ttp, T(frame)), jt.transform_frame(jtp, jnp.asarray(frame)),
                 LAYER, "transform_frame")
    g = torch.Generator().manual_seed(0)
    tp = tt.random_transform_params(g, 512, sigma_affine=0.05, sigma_tps=0.005)
    assert tp.theta.shape == (512, 2, 3) and tp.control_params.shape == (512, 1, 25)
    assert_close(tp.control_points, cp, 0, "control points")
    assert abs(float((tp.theta - torch.eye(2, 3)).std()) - 0.05) < 0.005
    assert abs(float(tp.control_params.std()) - 0.005) < 0.0005
