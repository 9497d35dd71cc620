"""PyTorch port: LPIPS (facevae_tpu_torch/losses/lpips.py) and the dormant
contrastive losses (contrastive_loss, ContrastiveHeadConv,
ContrastiveHeadConv2 in facevae_tpu_torch/losses/contrastive.py) against
the JAX package's, on the CPU, with the JAX variables filled from a numpy
seed (tools/make_torch_golden.py:fill_variables) and bridged by
facevae_tpu_torch.convert.

- LPIPS at 32x32 (full VGG16 widths; the fifth block at 2x2): the
  distance and its gradient with respect to both images; LPIPS(x, x) = 0.
- ContrastiveHeadConv on [2,32,32,8] maps: the loss and the gradients of
  both views and of the projection.  Its fp32 gradients are ill-conditioned
  at this seed: JAX's own answer moves by several times the tolerance
  (a region of one view's gradient) when the view is nudged by 2^-22, and
  the port's fp32 and float64 answers sit where JAX's nudged ones do; a
  discrete event (a ReLU or pool choice) flips inside JAX's unnudged
  evaluation.  So each gradient is held within the tolerance to the
  nearest of JAX's answers at the view and at the view times 1 +- 2^-22.
- ContrastiveHeadConv2 at its default widths on [4,4,4,256] (projection
  2x2: the (C, h, w) flatten order shows), training form (batch
  statistics; the running statistics after its four BatchNorm calls) and
  eval form: the loss and the gradients of both views and every parameter
  (in the training form the batch mean cancels proj_conv's bias, whose
  gradient is rounding noise: held to the tolerance times max|d weight|).

Tolerance 1e-4 of max|ref| (tests/test_torch_losses.py's for whole nets:
a dozen fp32 convolutions summed in another order), 1e-5 for
contrastive_loss.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.losses import contrastive as jc, lpips as jl
from facevae_tpu_torch.convert import load_jax_variables, state_dict_from_jax
from facevae_tpu_torch.losses import (LPIPS, ContrastiveHeadConv, ContrastiveHeadConv2,
                                      contrastive_loss)
from torch_parity import assert_close, golden, one_torch_thread  # noqa: F401

NET, LAYER = 1e-4, 1e-5


def _held_nearest(actual, refs, rel, what):
    """max|actual - ref| <= rel * max|refs[0]| for the nearest of refs."""
    errs = [float(np.abs(np.asarray(actual) - np.asarray(r)).max()) for r in refs]
    scale = float(np.abs(np.asarray(refs[0])).max())
    assert min(errs) <= rel * scale, f"{what}: max|err| {errs} > {rel:g} * {scale:.3e}"


def _vars(module, *args, rs, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return golden.fill_variables(dict(shapes), rs)


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX LPIPS, its seeded variables and the port's LPIPS over them."""
    rs = np.random.RandomState(5)
    jm = jl.LPIPS()
    z = jnp.zeros((1, 32, 32, 3))
    v = _vars(jm, z, z, rs=rs)
    return jm, v, load_jax_variables(LPIPS(), v)


def test_lpips(lpips_pair):
    """The distance of two batches of images and its gradients; identical
    images are at distance 0; the parameters get no gradient."""
    jm, v, port = lpips_pair
    rs = np.random.RandomState(6)
    x, y = (rs.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    c = np.asarray([1.0, -0.5], np.float32)

    @jax.jit
    def run(v, x, y):
        def f(x, y):
            d = jm.apply(v, x, y)
            return jnp.sum(d * c), d
        (_, d), g = jax.value_and_grad(f, (0, 1), has_aux=True)(x, y)
        return d, g
    ref, (gx, gy) = run(v, x, y)
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    out = port(tx, ty)
    (out * torch.from_numpy(c)).sum().backward()
    assert out.shape == (2,) and out.dtype == torch.float32
    assert_close(out, ref, NET, "LPIPS")
    assert_close(tx.grad, gx, NET, "d x")
    assert_close(ty.grad, gy, NET, "d y")
    assert all(p.grad is None and not p.requires_grad for p in port.parameters())
    with torch.no_grad():
        assert torch.equal(port(tx, tx), torch.zeros(2))


def test_contrastive_loss(rng):
    f1, f2 = (rng.randn(3, 2, 4, 5).astype(np.float32) for _ in range(2))
    assert_close(contrastive_loss(torch.from_numpy(f1), torch.from_numpy(f2)),
                 jc.contrastive_loss(jnp.asarray(f1), jnp.asarray(f2)), LAYER, "contrastive_loss")
    assert abs(float(contrastive_loss(torch.from_numpy(f1), torch.from_numpy(f1)))) < 1e-6


def test_contrastive_head_conv(lpips_pair, rng):
    """The 1x1 projection to 3 channels, then the mean LPIPS distance; the
    frozen LPIPS comes in apart."""
    jm, lv, lpips = lpips_pair
    f1, f2 = (rng.randn(2, 32, 32, 8).astype(np.float32) for _ in range(2))
    jhead = jc.ContrastiveHeadConv()
    v = _vars(jhead, jnp.asarray(f1), jnp.asarray(f2), lv, rs=rng)

    @jax.jit
    def run(v, lv, a, b):
        return jax.value_and_grad(lambda v, a, b: jhead.apply(v, a, b, lv), (0, 1, 2))(v, a, b)
    answers = [run(v, lv, jnp.asarray(f1 * np.float32(1 + e)), jnp.asarray(f2))
               for e in (0.0, 2.0 ** -22, -2.0 ** -22)]
    head = load_jax_variables(ContrastiveHeadConv(8), v)
    assert set(head.state_dict()) == {"projection.weight", "projection.bias"}
    t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (f1, f2))
    loss = head(t1, t2, lpips)
    loss.backward()
    assert_close(loss, answers[0][0], NET, "loss")
    _held_nearest(t1.grad, [a[1][1] for a in answers], NET, "d view 1")
    _held_nearest(t2.grad, [a[1][2] for a in answers], NET, "d view 2")
    grads = [state_dict_from_jax(a[1][0]) for a in answers]
    for k, p in head.named_parameters():
        _held_nearest(p.grad, [g[k] for g in grads], NET, f"d {k}")


@pytest.mark.parametrize("train", [True, False])
def test_contrastive_head_conv2(rng, train):
    """Default widths (256 -> 128, predictor 512) on [4,4,4,256] in the
    training form (and its BatchNorm statistics) and the eval form."""
    f1, f2 = (rng.randn(4, 4, 4, 256).astype(np.float32) for _ in range(2))
    jhead = jc.ContrastiveHeadConv2()
    v = _vars(jhead, jnp.asarray(f1), jnp.asarray(f2), rs=rng)

    @jax.jit
    def run(v, a, b):
        def f(v, a, b):
            if train:
                return jhead.apply(v, a, b, train=True, mutable=["batch_stats"])
            return jhead.apply(v, a, b, train=False), {}
        return jax.value_and_grad(f, (0, 1, 2), has_aux=True)(v, a, b)
    (ref, upd), (gv, g1, g2) = run(v, jnp.asarray(f1), jnp.asarray(f2))
    head = load_jax_variables(ContrastiveHeadConv2(), v).train(train)
    t1, t2 = (torch.from_numpy(a).requires_grad_() for a in (f1, f2))
    loss = head(t1, t2)
    loss.backward()
    assert_close(loss, ref, NET, "loss")
    assert_close(t1.grad, g1, NET, "d view 1")
    assert_close(t2.grad, g2, NET, "d view 2")
    grads = state_dict_from_jax({"params": gv["params"]})
    for k, p in head.named_parameters():
        if train and k == "proj_conv.bias":
            scale = float(np.abs(grads["proj_conv.weight"]).max())
            assert float((p.grad - torch.tensor(grads[k])).abs().max()) <= NET * scale
        else:
            assert_close(p.grad, grads[k], NET, f"d {k}")
    bufs = dict(head.named_buffers())
    stats = state_dict_from_jax({"batch_stats": upd["batch_stats"] if train
                                 else v["batch_stats"]})
    assert set(stats) == set(bufs)
    for k, s in stats.items():
        assert_close(bufs[k], s, NET, k)
