"""PyTorch port: the bf16 training step (ModelConfig.compute_dtype =
"bfloat16") against facevae_tpu's, at tiny_config() and batch 2 on the CPU.

The JAX policy (facevae_tpu/train/objective.py:93-96): the conv stacks run in
bf16, with fp32 parameters cast per call; geometry, softmax heatmaps, warp
coordinates and every loss reduction stay fp32; parameters, BatchNorm
statistics and Adam state stay fp32.

Both packages round to bf16, but not at the same places (PyTorch's and
XLA's bf16 kernels; the warp, where the port's plain versions sum bf16
inputs in fp32 and JAX on the CPU runs its one-hot path with bf16 weights).
So each answer is held to JAX's bf16 answer within SPREAD (3) x the bf16
rounding noise on that quantity plus a floor: two independent bf16
roundings of one fp32 computation each lie about that far from it.  The
noise is JAX's own bf16-vs-fp32 difference and, for the step, also the
port's bf16 answer's change when the images move by half a bf16 ulp (NUDGE):
what hangs on BatchNorm over few samples and on the 0.1-temperature
soft-argmax moves that much under bf16 rounding, more than one run's
bf16-vs-fp32 difference shows (measured on this state: the contrastive loss
C 1.2% off its fp32 value in the port, 0.2% in JAX, and 1-5% between nudged
inputs; the BatchNorm weight gradients of AFE's last ResBlock and HPE_EDE's
third bottleneck by more than their own size).  The fp32 answers are the
port's on the same values, which tests/test_torch_{models,losses,train}.py
hold to JAX's fp32 answers far inside the bf16 noise.
- single layers (Conv, spectral Conv, Dense, BatchNorm, InstanceNorm) on a
  bf16 input: bf16 outputs within LAYER (1e-2, about two bf16 roundings) of
  max|ref|, fp32 parameter gradients held as above with the floor LAYER;
- each net in eval form on bf16 inputs: output dtypes as JAX's, values held
  as above with the floor LAYER;
- the bf16 TPS branch against JAX's on its chip (the Pallas multi-grid
  forward in interpret mode): 2%, the Pallas forward's tolerance;
- the whole G+D step, with JAX's TPS warp on that same branch: every loss
  (floor LOSS_REL of it) and the gradient of every G and D parameter (floor
  GRAD_REL of the larger of the leaf's max|ref| and GRAD_FLOOR of its net's
  largest gradient, as in test_torch_train.py).
Parameters, buffers and Adam state must be fp32 after the step, and the step
must run the warp as the JAX package's bf16 step on its chip does: the
multi-grid warp three times forward (MFE, Generator, TPS) and twice
backward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config as jax_tiny_config
from facevae_tpu.nn import BatchNorm as JaxBatchNorm, Conv as JaxConv, Dense as JaxDense
from facevae_tpu.nn.layers import InstanceNorm as JaxInstanceNorm
from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu.ops import tps as jt
from facevae_tpu.ops.geometry import make_coordinate_grid_2d, make_coordinate_grid_3d, pose_rotation
from facevae_tpu.ops.grid_sample import _reflect as jax_reflect
from facevae_tpu.ops.pallas import warp_mm
from facevae_tpu.train import objective as jax_objective
from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_train_state, load_jax_variables, state_dict_from_jax
from facevae_tpu_torch.models import D_MODEL_NAMES, G_MODEL_NAMES
from facevae_tpu_torch.nn import BatchNorm, Conv, Dense, InstanceNorm
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.ops import tps as tt
from facevae_tpu_torch.train import LOSS_NAMES, build_all_modules, create_train_state, train_step
from torch_parity import assert_close, golden, one_torch_thread, to_np  # noqa: F401

LAYER = 1e-2
NET = 2e-2
SPREAD = 3.0
LOSS_REL = 1e-3
GRAD_REL = 1e-2
GRAD_FLOOR = 1e-2
NUDGE = 2.0 ** -9
BF16 = jnp.bfloat16


def _bf16(a):
    """numpy values rounded to bf16 (held as fp32 numpy)."""
    return np.array(jnp.asarray(a, BF16).astype(jnp.float32))


def _cl(t):
    return t.permute(0, *range(2, t.dim()), 1)


def _nchw(t):
    return t.permute(0, t.dim() - 1, *range(1, t.dim() - 1))


def _vars(module, *args, rs):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    return golden.fill_variables(dict(shapes), rs)


def _held(actual, ref, spreads, rel, what, scale=None):
    """max|actual - ref| <= SPREAD * max over ``spreads`` (pairs of answers
    whose distance is bf16 rounding noise) + rel * scale; scale defaults to
    max|ref|."""
    actual, ref = to_np(actual).astype(np.float64), to_np(ref).astype(np.float64)
    assert actual.shape == ref.shape, (what, actual.shape, ref.shape)
    err = float(np.abs(actual - ref).max())
    noise = max(float(np.abs(to_np(a).astype(np.float64) - to_np(b)).max()) for a, b in spreads)
    scale = float(np.abs(ref).max()) if scale is None else scale
    limit = SPREAD * noise + rel * scale
    assert err <= limit, (f"{what}: max|err| {err:.3e} > {SPREAD:g} * bf16 spread {noise:.3e} "
                          f"+ {rel:g} * scale {scale:.3e}")


LAYERS = {   # name: (JAX module, port module, input shape [N,...,C], channel-last io)
    "conv2d": (lambda: JaxConv(6, 3, 1, 1, dim=2), lambda: Conv(4, 6, 3, 1, 1, dim=2),
               (2, 7, 6, 4)),
    "conv3d_spectral": (lambda: JaxConv(6, 3, 1, 1, dim=3, use_spectral_norm=True),
                        lambda: Conv(4, 6, 3, 1, 1, dim=3, spectral_norm=True), (2, 3, 5, 4, 4)),
    "dense": (lambda: JaxDense(6), lambda: Dense(4, 6), (5, 4)),
    "batchnorm": (lambda: JaxBatchNorm(4), lambda: BatchNorm(4), (3, 5, 6, 4)),
    "instancenorm": (lambda: JaxInstanceNorm(4), lambda: InstanceNorm(4), (2, 5, 6, 4)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_bf16_form(rng, name):
    """Training form on a bf16 input: a bf16 output within LAYER of JAX's;
    fp32 parameters, and fp32 parameter gradients held to JAX's bf16 ones
    within SPREAD x JAX's own bf16-vs-fp32 difference plus LAYER (XLA on the
    CPU sums a bias gradient in bf16: 1-2% off its fp32 value)."""
    jmake, tmake, shape = LAYERS[name]
    x = _bf16(rng.randn(*shape) * 2 + 0.5)
    cot = _bf16(rng.randn(*shape[:-1], 6 if name in ("conv2d", "conv3d_spectral", "dense")
                          else shape[-1]))
    jm = jmake()
    v = _vars(jm, jnp.asarray(x), rs=rng)

    def f(params, dtype):
        args = ({**v, "params": params}, jnp.asarray(x, dtype))
        y = (jm.apply(*args) if name == "dense" else
             jm.apply(*args, train=True, mutable=["batch_stats", "spectral"])[0])
        return jnp.sum(y.astype(jnp.float32) * cot), y

    (_, y), g = jax.value_and_grad(lambda p: f(p, BF16), has_aux=True)(v["params"])
    g32 = jax.grad(lambda p: f(p, jnp.float32)[0])(v["params"])
    m = load_jax_variables(tmake(), v).train()
    xt = torch.from_numpy(x).bfloat16()
    out = m(xt) if name == "dense" else _cl(m(_nchw(xt)))
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert y.dtype == BF16 and out.dtype == torch.bfloat16
    assert_close(out.float(), np.asarray(y, np.float32), LAYER, f"{name} output")
    ref, ref32 = (state_dict_from_jax({"params": t}) for t in (g, g32))
    for k, p in m.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k
        _held(p.grad, ref[k], [(ref[k], ref32[k])], LAYER, f"{name} d{k}")


@pytest.fixture(scope="module")
def jax_env():
    """tiny_config(compute_dtype="bfloat16"), the JAX modules of the train
    step and their variables, every tree filled from one numpy seed
    (tools/make_torch_golden.py:train_variables).  remat recomputes the same
    values; without it JAX traces and compiles the step faster (the port
    does not honour remat)."""
    cfg = jax_tiny_config(compute_dtype="bfloat16")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=False))
    return (cfg, *golden.train_variables(cfg, seed=21))


@pytest.fixture(scope="module")
def nets_env(jax_env):
    cfg, jmodels, variables = jax_env
    m = cfg.model
    tmodels = build_all_modules(tiny_config(compute_dtype="bfloat16"), "cpu")
    for name, model in tmodels.items():
        load_jax_variables(model, variables[name])
    rs = np.random.RandomState(8)
    N, K, hq = 2, m.num_kp, m.image_size // 4
    img, img2 = (_bf16(rs.rand(N, m.image_size, m.image_size, 3)) for _ in range(2))
    kp = [rs.uniform(-0.6, 0.6, (N, K, 3)).astype(np.float32) for _ in range(3)]
    R = [np.array(pose_rotation(*[rs.uniform(-0.5, 0.5, N).astype(np.float32)
                                  for _ in range(3)])) for _ in range(2)]
    fs = _bf16(0.5 * rs.randn(N, m.depth, hq, hq, m.app_channels))
    grid = np.asarray(make_coordinate_grid_3d((m.depth, hq, hq)))
    deformation = (grid[None] + rs.normal(0, 0.1, (N, m.depth, hq, hq, 3))).astype(np.float32)
    occlusion = _bf16(rs.rand(N, hq, hq, 1))
    bf = {"img", "img2", "fs", "occlusion"}
    inputs = {"afe": ("img",), "ckd": ("img",), "hpe_ede": ("img",),
              "efe": ("img", "img2", "kp0"), "mfe": ("fs", "kp1", "kp2", "R0", "R1"),
              "generator": ("fs", "deformation", "occlusion"),
              "discriminator": ("img", "kp0"), "hopenet": ("img224",),
              "perceptual": ("img", "img2")}
    arrays = {"img": img, "img2": img2, "fs": fs, "deformation": deformation,
              "occlusion": occlusion, "img224": _bf16(rs.rand(N, 224, 224, 3)),
              **{f"kp{i}": k for i, k in enumerate(kp)}, **{f"R{i}": r for i, r in enumerate(R)}}
    return dict(variables=variables, jmodels=jmodels, tmodels=tmodels, inputs=inputs,
                arrays=arrays, bf=bf | {"img224"})


def _outputs(out):
    if isinstance(out, (tuple, list)):
        return [o for x in out for o in _outputs(x)]
    return [] if out is None else [out]


@pytest.mark.parametrize("name", list(G_MODEL_NAMES + D_MODEL_NAMES) + ["hopenet", "perceptual"])
def test_net_bf16_forward(nets_env, name):
    """Each net in eval form on bf16 inputs (fp32 geometry): every output's
    dtype as JAX's, and its values held to JAX's within SPREAD x the
    bf16-vs-fp32 difference plus LAYER (the fp32 answer is the port's on the
    same values, which tests/test_torch_models.py and test_torch_losses.py
    hold to JAX's within 1e-4)."""
    keys = nets_env["inputs"][name]
    arrs = [nets_env["arrays"][k] for k in keys]
    jargs = [jnp.asarray(a, BF16 if k in nets_env["bf"] else jnp.float32)
             for k, a in zip(keys, arrs)]
    jm, tm = nets_env["jmodels"][name], nets_env["tmodels"][name].eval()
    kw = {} if name == "perceptual" else {"train": False}
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, **kw))(nets_env["variables"][name], *jargs)
    with torch.no_grad():
        port = tm(*[torch.from_numpy(a).to(torch.bfloat16 if k in nets_env["bf"] else
                                            torch.float32) for k, a in zip(keys, arrs)])
        fp32 = tm(*[torch.from_numpy(a) for a in arrs])
    ref, port, fp32 = _outputs(ref), _outputs(port), _outputs(fp32)
    assert len(ref) == len(port) == len(fp32) > 0
    for i, (p, r, f) in enumerate(zip(port, ref, fp32)):
        assert str(p.dtype).split(".")[-1] == str(r.dtype), (name, i, p.dtype, r.dtype)
        r = np.asarray(r, np.float32)
        _held(p.float(), r, [(r, f)], LAYER, f"{name} output {i}")


def jax_tps_chip_branch(tp, frame, compute_dtype=None):
    """facevae_tpu/ops/tps.py:transform_frame as it runs on its chip, where
    a bf16 frame takes the multi-grid Pallas kernel (plan G=1, no z-band):
    here warp_mm_fwd_multi_pallas in interpret mode.  (Off the chip JAX
    takes the fp32 gather, and its warp_multi_pixel fallback cannot take a
    D=1 volume.)  fp32 calls go to the unchanged function."""
    if compute_dtype != BF16:
        return jt.transform_frame(tp, frame, compute_dtype)
    N, H, W, C = frame.shape
    grid = make_coordinate_grid_2d((H, W), jnp.float32).reshape(1, H * W, 2)
    grid = jt.warp_coordinates(tp, grid).reshape(N, H, W, 2)

    def px(g, n):
        p = (g + 1.0) * 0.5 * (n - 1)
        return jnp.clip(jax_reflect(p, 0.0, float(n - 1)), 0.0, float(n - 1))

    gx, gy = px(grid[..., 0], W).reshape(N, 1, H * W), px(grid[..., 1], H).reshape(N, 1, H * W)
    x = frame.astype(BF16)[:, None]
    out = warp_mm.warp_mm_fwd_multi_pallas(jfw._rows4(x, 1), gx, gy, jnp.zeros_like(gx), D=1,
                                           H=H, W=W, Cg=C, K1=1, G=1, VB=512)
    return out.reshape(N, H, W, C).astype(BF16)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(warp_mm.pl, "pallas_call",
                        functools.partial(warp_mm.pl.pallas_call, interpret=True))


def _tp(rs, N):
    return (np.eye(2, 3, dtype=np.float32)[None] + 0.05 * rs.randn(N, 2, 3).astype(np.float32),
            np.array(make_coordinate_grid_2d((5, 5))).reshape(1, 25, 2),
            (0.005 * rs.randn(N, 1, 25)).astype(np.float32))


def test_tps_bf16_branch(interpret, rng):
    """transform_frame's bf16 branch against the JAX package's on its chip
    (jax_tps_chip_branch): bf16 out, within 2% of max|ref|, the Pallas
    forward's tolerance (it rounds its one-hot weights to bf16)."""
    frame = rng.rand(2, 64, 64, 3).astype(np.float32)
    tp = _tp(rng, 2)
    ref = jax_tps_chip_branch(jt.TransformParams(*map(jnp.asarray, tp)), jnp.asarray(frame), BF16)
    fast_warp.reset_launch_counts()
    out = tt.transform_frame(tt.TransformParams(*map(torch.from_numpy, tp)),
                             torch.from_numpy(frame), compute_dtype=torch.bfloat16)
    assert fast_warp.launches == {**dict.fromkeys(fast_warp.launches, 0), "warp_fwd_plain": 1}
    assert out.dtype == torch.bfloat16 and ref.dtype == BF16
    assert_close(out.float(), np.asarray(ref, np.float32), 2e-2, "TPS bf16 branch")


# -- the whole bf16 step ---------------------------------------------------------

def _port_step(tree, dtype, batch, tp):
    """The port's step at ``dtype`` from the JAX train state ``tree``:
    (state, outputs, warp launches)."""
    cfg = tiny_config(compute_dtype=dtype)
    nets = build_all_modules(cfg, "cpu")
    load_jax_train_state(nets, tree)
    state = create_train_state(cfg, "cpu", nets)
    fast_warp.reset_launch_counts()
    out = train_step(state, tuple(torch.from_numpy(b.copy()) for b in batch),
                     transform_params=tt.TransformParams(*(torch.from_numpy(a.copy()) for a in tp)))
    return state, out, dict(fast_warp.launches)


@pytest.fixture(scope="module")
def step_env(jax_env):
    """One JAX train state, one batch and one set of TPS parameters.  The
    reference: the JAX step's losses and gradients at bf16, its TPS warp on
    its chip's branch (jax_tps_chip_branch, the branch the port takes).  The
    port's steps: bf16 on the batch, fp32 on the batch (the fp32 answer:
    one JAX compile here, not two), bf16 on the batch nudged by NUDGE."""
    cfg, models, variables = jax_env
    rs = np.random.RandomState(5)
    batch = tuple(rs.rand(2, cfg.model.image_size, cfg.model.image_size, 3).astype(np.float32)
                  for _ in range(4))
    tp = _tp(rs, 2)
    jstate = golden.jax_train_state(cfg, variables)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(warp_mm.pl, "pallas_call",
                   functools.partial(warp_mm.pl.pallas_call, interpret=True))
        mp.setattr(jax_objective, "transform_frame", jax_tps_chip_branch)
        ref = golden.jax_step_grads(cfg, models, jstate, tuple(map(jnp.asarray, batch)),
                                    jax.random.PRNGKey(0),
                                    jt.TransformParams(*map(jnp.asarray, tp)))
    tree = golden.train_state_tree(jstate)
    nudged = tuple((b * (1 + NUDGE * rs.randn(*b.shape))).astype(np.float32) for b in batch)
    steps = {k: _port_step(tree, dt, b, tp) for k, dt, b in (
        ("bf16", "bfloat16", batch), ("fp32", "float32", batch), ("nudged", "bfloat16", nudged))}
    return dict(ref=ref, steps=steps)


def _spreads(env, pick):
    """The (answer, answer) pairs whose distance is bf16 rounding noise on
    the quantity pick(step) / pick(JAX answer): JAX's bf16 vs fp32, and the
    port's bf16 on nudged inputs vs on the inputs."""
    steps = env["steps"]
    return [(pick(env["ref"]), pick(steps["fp32"])), (pick(steps["nudged"]), pick(steps["bf16"]))]


def _loss(phase, k):
    return lambda ans: ans[phase][k] if isinstance(ans, dict) else ans[1][phase][k]


def test_bf16_step_losses_and_launches(step_env):
    out = step_env["steps"]["bf16"][1]
    for phase, names in (("losses_g", LOSS_NAMES), ("losses_d", ("G1", "G2"))):
        for k in names:
            _held(out[phase][k], step_env["ref"][phase][k], _spreads(step_env, _loss(phase, k)),
                  LOSS_REL, f"loss {k}")
    assert step_env["steps"]["bf16"][2] == {**dict.fromkeys(fast_warp.launches, 0),
                                            "warp_fwd_plain": 3, "warp_bwd_dgrid_plain": 2,
                                            "warp_bwd_dx_plain": 2}


def _grad(col, name, key):
    def pick(ans):
        if isinstance(ans, dict):
            return state_dict_from_jax({"params": ans[col][name]})[key]
        return dict(ans[0].nets[name].named_parameters())[key].grad
    return pick


@pytest.mark.parametrize("name", G_MODEL_NAMES + D_MODEL_NAMES)
def test_bf16_step_gradients(step_env, name):
    col = "d_grads" if name in D_MODEL_NAMES else "g_grads"
    ref = state_dict_from_jax({"params": step_env["ref"][col][name]})
    port = dict(step_env["steps"]["bf16"][0].nets[name].named_parameters())
    assert set(ref) == set(port)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for key, r in ref.items():
        g = port[key].grad
        assert g is not None and g.dtype == torch.float32, f"{name}.{key}"
        _held(g, r, _spreads(step_env, _grad(col, name, key)), GRAD_REL, f"{name}.{key} grad",
              scale=max(float(np.abs(r).max()), GRAD_FLOOR * top))


def test_bf16_step_golden_is_reproduced():
    """tests/data/torch_bf16_step_tiny.npz (tools/make_torch_step_golden.py),
    the CPU bf16 step chip_smoke.py holds the card's to: recomputed here and
    held to it by chip_smoke's own rule."""
    import chip_smoke
    z = np.load(chip_smoke.BF16_STEP_GOLDEN)
    _, batch, tp = chip_smoke.tiny_step_inputs()
    losses, grads = chip_smoke.tiny_step("cpu", batch, "bfloat16", tp)
    ref_grads = {}
    for k in z.files:
        if k.startswith("grad/"):
            _, n, key = k.split("/", 2)
            ref_grads.setdefault(n, {})[key] = z[k]
    assert set(ref_grads) == set(grads)
    bad, _ = chip_smoke.held_step(
        losses, grads, {k: float(z[f"loss/{k}"]) for k in losses}, ref_grads,
        lambda kind, n, k: float(z[f"noise/loss/{n}" if kind == "loss" else f"noise/grad/{n}/{k}"]),
        chip_smoke.BF16_SPREAD, chip_smoke.BF16_TRAIN_TOL)
    assert not bad, bad[:8]


def test_bf16_step_keeps_state_fp32(step_env):
    state = step_env["steps"]["bf16"][0]
    assert {p.dtype for m in state.nets.values() for p in m.parameters()} == {torch.float32}
    assert {b.dtype for m in state.nets.values() for b in m.buffers()} == {torch.float32}
    moments = [v for opt in (state.g_opt, state.d_opt) for st in opt.state.values()
               for v in st.values()]
    assert moments and {v.dtype for v in moments} == {torch.float32}
