"""PyTorch port: the weight-normalized and untied-bias layers
(facevae_tpu_torch/nn/wn.py) against facevae_tpu/nn/wn.py on the CPU.

Every WN and UB layer: the same numpy-filled variables bridged by
facevae_tpu_torch.convert, the forward, the gradients of sum(out * c) with
respect to the input and every parameter, and the bridge both ways (JAX ->
port -> JAX bit for bit: the weights and the untied biases keep the JAX
layout).  The transposed conv: F.conv_transpose2d(stride, padding=p)
against the JAX package's lhs-dilated form at odd and even sizes, strides 1
and 2.  fuse_wn: the forward unchanged, and the fused weights and gains
equal to the JAX fuse_wn's given every transposed layer's path.

Tolerances, max|err| <= REL * max|ref|: 1e-5 for outputs and gradients
(fp32 convolutions summed in another order); fuse_wn's weights and gains
1e-6 (one fp32 rounding apart: the global norm's sum order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facevae_tpu.nn import wn as jwn
from facevae_tpu_torch.convert import (jax_tree_from_state_dict, load_jax_variables,
                                       state_dict_from_jax, weight_as_is)
from facevae_tpu_torch.nn import init_parameters, wn
from torch_parity import assert_close, one_torch_thread  # noqa: F401

REL, FUSE = 1e-5, 1e-6


def _cf(a):
    """channel-last numpy -> channel-first tensor"""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    return t.detach().movedim(1, -1).numpy()


def _fill(jm, x, rs):
    """The JAX layer's variables: N(0,1) weights, gains in [0.5, 1.5],
    biases N(0, 0.1^2) (vector or untied map)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    draw = {"weight": lambda s: rs.randn(*s), "g": lambda s: rs.uniform(0.5, 1.5, s),
            "bias": lambda s: 0.1 * rs.randn(*s)}
    return {"params": {k: draw[k](s.shape).astype(np.float32)
                       for k, s in shapes["params"].items()}}


def _held(jm, pm, x, rs):
    """jm (JAX) and pm (port) on x (channel-last, or [N, in] for LinearWN):
    outputs, input and parameter gradients, the bridge both ways."""
    v = _fill(jm, x, rs)
    flat = x.ndim == 2
    c = rs.randn(*jax.eval_shape(jm.apply, v, jnp.asarray(x)).shape).astype(np.float32)

    @jax.jit
    def run(v, x, c):
        def loss(v, x):
            out = jm.apply(v, x)
            return jnp.sum(out * c), out
        (_, out), grads = jax.value_and_grad(loss, (0, 1), has_aux=True)(v, x)
        return out, grads
    jout, (jgv, jgx) = run(v, jnp.asarray(x), c)
    load_jax_variables(pm, v)
    back = jax_tree_from_state_dict({k: t.numpy() for k, t in pm.state_dict().items()},
                                    weight_as_is(pm))
    assert back.keys() == v.keys() and back["params"].keys() == v["params"].keys()
    for k, a in v["params"].items():
        assert np.array_equal(back["params"][k], a), k
    tx = (torch.from_numpy(x) if flat else _cf(x)).requires_grad_()
    out = pm(tx)
    (out * (torch.from_numpy(c) if flat else _cf(c))).sum().backward()
    assert_close(out.detach() if flat else _cl(out), jout, REL, "forward")
    assert_close(tx.grad if flat else _cl(tx.grad), jgx, REL, "d input")
    jgrads = state_dict_from_jax(jgv)
    for k, p in pm.named_parameters():
        assert_close(p.grad, jgrads[k], REL, f"d {k}")


@pytest.mark.parametrize("case", ["linear", "conv", "conv_transpose"])
def test_wn_layers(rng, case):
    """LinearWN; Conv2dWN at strides 1 and 2; ConvTranspose2dWN at stride 2
    and square (in = out, where g's axis 1 cannot be told from the shape)."""
    if case == "linear":
        for bias in (True, False):
            _held(jwn.LinearWN(7, 5, use_bias=bias), wn.LinearWN(7, 5, bias=bias),
                  rng.randn(3, 7).astype(np.float32), rng)
    elif case == "conv":
        for s in (1, 2):
            _held(jwn.Conv2dWN(3, 5, 3, strides=s, padding=1),
                  wn.Conv2dWN(3, 5, 3, stride=s, padding=1),
                  rng.randn(2, 9, 8, 3).astype(np.float32), rng)
    else:
        for cin, cout, k in ((3, 5, 4), (4, 4, 3)):
            _held(jwn.ConvTranspose2dWN(cin, cout, k, strides=2, padding=1),
                  wn.ConvTranspose2dWN(cin, cout, k, stride=2, padding=1),
                  rng.randn(2, 5, 4, cin).astype(np.float32), rng)


@pytest.mark.parametrize("family", ["conv2d", "conv_transpose2d", "3d"])
def test_untied_bias_layers(rng, family):
    """All six factories: Conv2dUB / Conv2dWNUB, ConvTranspose2dUB /
    ConvTranspose2dWNUB, Conv3dUB / ConvTranspose3dUB."""
    if family == "conv2d":
        x = rng.randn(2, 8, 6, 3).astype(np.float32)
        cases = [(getattr(jwn, n)(3, 5, 8, 6, 3, padding=1),
                  getattr(wn, n)(3, 5, 8, 6, 3, padding=1)) for n in ("Conv2dUB", "Conv2dWNUB")]
    elif family == "conv_transpose2d":
        x = rng.randn(2, 5, 4, 3).astype(np.float32)
        cases = [(getattr(jwn, n)(3, 5, 10, 8, 4, strides=2, padding=1),
                  getattr(wn, n)(3, 5, 10, 8, 4, stride=2, padding=1))
                 for n in ("ConvTranspose2dUB", "ConvTranspose2dWNUB")]
    else:
        x = rng.randn(1, 3, 4, 5, 2).astype(np.float32)
        cases = [(jwn.Conv3dUB(2, 4, 3, 4, 5, 3, padding=1),
                  wn.Conv3dUB(2, 4, 3, 4, 5, 3, padding=1)),
                 (jwn.ConvTranspose3dUB(2, 4, 6, 8, 10, 4, strides=2, padding=1),
                  wn.ConvTranspose3dUB(2, 4, 6, 8, 10, 4, stride=2, padding=1))]
    for jm, pm in cases:
        _held(jm, pm, x, rng)


def test_conv_transpose_is_the_lhs_dilated_conv(rng):
    """F.conv_transpose2d(x, w, stride=s, padding=p) equals the JAX
    package's form (lhs_dilation = s, padding k - 1 - p, flipped kernel) at
    odd and even sizes, strides 1 and 2."""
    for size in (5, 6):
        for s in (1, 2):
            for k, p in ((3, 1), (4, 1), (3, 0)):
                x = rng.randn(2, size, size + 1, 3).astype(np.float32)
                w = rng.randn(3, 4, k, k).astype(np.float32)
                ref = jwn._conv_transpose_cl(jnp.asarray(x), jnp.asarray(w), s, p, 2)
                out = F.conv_transpose2d(_cf(x), torch.from_numpy(w), None, s, p)
                assert_close(_cl(out), ref, REL, f"size {size} stride {s} k {k} p {p}")


def test_fuse_wn(rng):
    """fuse_wn over a module of every WN kind, square transposed layers
    included, against the JAX fuse_wn given every transposed layer's path;
    the forward unchanged; a UB layer without WN untouched."""
    specs = {
        "lin": (jwn.LinearWN(6, 4), wn.LinearWN(6, 4), (3, 6), False),
        "conv": (jwn.Conv2dWN(3, 5, 3, padding=1), wn.Conv2dWN(3, 5, 3, padding=1),
                 (2, 6, 6, 3), False),
        "up_square": (jwn.ConvTranspose2dWN(4, 4, 3, strides=2, padding=1),
                      wn.ConvTranspose2dWN(4, 4, 3, stride=2, padding=1), (2, 5, 5, 4), True),
        "up_ub": (jwn.ConvTranspose2dWNUB(4, 4, 10, 10, 4, strides=2, padding=1),
                  wn.ConvTranspose2dWNUB(4, 4, 10, 10, 4, stride=2, padding=1),
                  (2, 5, 5, 4), True),
        "ub": (jwn.Conv2dUB(3, 5, 6, 6, 3, padding=1), wn.Conv2dUB(3, 5, 6, 6, 3, padding=1),
               (2, 6, 6, 3), False),
    }
    port = torch.nn.ModuleDict({n: pm for n, (_, pm, _, _) in specs.items()})
    tree, xs, before = {}, {}, {}
    for n, (jm, pm, shape, _) in specs.items():
        xs[n] = rng.randn(*shape).astype(np.float32)
        tree[n] = _fill(jm, xs[n], rng)["params"]
        load_jax_variables(pm, {"params": tree[n]})
    with torch.no_grad():
        for n, (_, pm, shape, _) in specs.items():
            before[n] = pm(torch.from_numpy(xs[n]) if len(shape) == 2 else _cf(xs[n]))
        ub_weight = port["ub"].weight.clone()
        assert wn.fuse_wn(port) is port
        for n, (_, pm, shape, _) in specs.items():
            after = pm(torch.from_numpy(xs[n]) if len(shape) == 2 else _cf(xs[n]))
            assert_close(after, before[n], FUSE, f"{n} forward after fusion")
    assert torch.equal(port["ub"].weight, ub_weight)
    fused = jwn.fuse_wn(tree, transpose_paths=[(n,) for n, s in specs.items() if s[3]])
    for n in specs:
        for k, a in fused[n].items():
            assert_close(getattr(port[n], k).detach(), a, FUSE, f"{n}.{k}")


def test_downsample_and_dilate(rng):
    """downsample2d (int padding and "reflect": 3 px, then none; strides 1
    and 2) and dilate2d (clipped at 1) against the JAX functions."""
    x = rng.rand(2, 11, 10, 3).astype(np.float32)
    for padding in (0, 2, "reflect"):
        for s in (1, 2):
            assert_close(_cl(wn.downsample2d(_cf(x), s, padding)),
                         jwn.downsample2d(jnp.asarray(x), s, padding), REL,
                         f"downsample2d stride {s} padding {padding}")
    y = 3.0 * x
    out = wn.dilate2d(_cf(y), 3, 1, 1)
    assert float(out.max()) == 1.0 and float(out.min()) < 1.0
    assert_close(_cl(out), jwn.dilate2d(jnp.asarray(y), 3, 1, 1), REL, "dilate2d")
    assert_close(_cl(wn.dilate2d(_cf(x), 2, 2, 0)), jwn.dilate2d(jnp.asarray(x), 2, 2, 0),
                 REL, "dilate2d stride 2")


def test_seeded_init():
    """init_parameters: weights U(+-1/sqrt(fan_in)) (fan_in = in * k^d, as
    the JAX layers count it for the transposed convs too), g = 1, vector
    biases U(+-1/sqrt(fan_in)), untied biases 0; the same seed the same
    draws."""
    nets = [wn.LinearWN(300, 200), wn.ConvTranspose2dWN(40, 30, 4, stride=2, padding=1),
            wn.Conv2dWNUB(8, 6, 5, 5, 3, padding=1)]
    for net in nets:
        init_parameters(torch.nn.Sequential(net), torch.Generator().manual_seed(3))
        bound = 1.0 / np.sqrt(net.fan_in)
        w = net.weight.detach().abs()
        assert float(w.max()) <= bound and float(w.max()) > 0.9 * bound
        assert torch.equal(net.g, torch.ones_like(net.g))
        if net.bias.dim() == 1:
            assert float(net.bias.detach().abs().max()) <= bound
        else:
            assert not bool(net.bias.any())
    assert nets[1].fan_in == 40 * 16
    again = wn.LinearWN(300, 200)
    init_parameters(torch.nn.Sequential(again), torch.Generator().manual_seed(3))
    assert torch.equal(again.weight, nets[0].weight)
