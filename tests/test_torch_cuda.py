"""PyTorch port on the card: the CUDA warp kernels (forward, and the
backward's dgrid and dx halves) against their plain versions, the wrappers'
refusals, the tiny golden pipeline through the forward kernel, and a tiny
training step through all three.  Every test skips without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from facevae_tpu_torch.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train import InferencePipeline, create_train_state, train_step
from torch_parity import assert_close, golden

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")


def _case(seed, N, D, H, W, C, K1, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, D, H, W, C, generator=g, device="cuda").to(dtype)
    size = torch.tensor([W, H, D], device="cuda").reshape(3, 1, 1, 1)
    c = torch.rand(3, N, K1, D * H * W, generator=g, device="cuda") * (size + 3) - 2
    pick = torch.rand(c.shape, generator=g, device="cuda")
    c = torch.where(pick < 0.1, c.round(), c)
    probes = torch.tensor([float("inf"), float("-inf"), float("nan"), 1e30, -1e6],
                          device="cuda")
    c = torch.where(pick > 0.98, probes[(pick * 1e4).long() % 5], c)
    return x, [c[a].contiguous() for a in range(3)], (D, H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 4, 15), (2, 4, 8, 8, 32, 1),
                                   (1, 3, 5, 7, 3, 2), (2, 2, 6, 6, 6, 3)])
def test_kernel_matches_plain(dtype, shape):
    """fp32: 1e-5 of max|ref| (the 8 products summed in another order);
    bf16: 1e-2 (each output rounded to bf16).  C=3/6/4/32 cover 1, 2, 4 and
    8 channels per thread; inf / NaN / far coordinates must weigh 0."""
    x, coords, spatial = _case(sum(shape), *shape, dtype)
    out = fast_warp.warp_multi_pixel_cuda(x, *coords, spatial)
    ref = fast_warp.warp_multi_pixel_plain(x, *coords, spatial)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.isfinite(out).all()
    assert_close(out.float(), ref.float(), 1e-5 if dtype == torch.float32 else 1e-2,
                 f"{shape} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 16, 16, 4, 15), (2, 4, 8, 8, 32, 1),
                                   (1, 3, 5, 7, 3, 2), (2, 2, 6, 6, 6, 3)])
def test_backward_kernels_match_plain(dtype, shape):
    """dgrid: 1e-5 of max|ref| in both dtypes (fp32 sums of the same bf16 or
    fp32 products, in another order); dx: 1e-5 in fp32 (atomics add in
    another order), 1e-2 in bf16 (each output rounded to bf16 once).
    Integer, last-index, inf / NaN and far coordinates are in the mix."""
    x, coords, spatial = _case(sum(shape) + 1, *shape, dtype)
    N, K1, C = shape[0], shape[5], shape[4]
    g = torch.Generator(device="cuda").manual_seed(7)
    gout = torch.randn(N, *spatial, K1 * C, generator=g, device="cuda").to(dtype)
    for a, size in enumerate((spatial[2], spatial[1], spatial[0])):
        coords[a][:, :, :3] = torch.tensor([0.0, size - 1.0, 1.0], device="cuda")
    dx, dgrid = fast_warp.warp_multi_pixel_bwd_cuda(x, *coords, gout, spatial)
    rdx, rdgrid = fast_warp.warp_multi_pixel_bwd_plain(x, *coords, gout, spatial)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dx.shape == x.shape
    assert_close(dx.float(), rdx.float(), 1e-5 if dtype == torch.float32 else 1e-2, "dx")
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert d.dtype == torch.float32 and torch.isfinite(d).all()
        assert_close(d, r, 1e-5, f"dgrid {'xyz'[a]}")


def test_backward_skips_what_autograd_does_not_need():
    x, coords, spatial = _case(3, 2, 4, 8, 8, 4, 3, torch.float32)
    x.requires_grad_()
    fast_warp.reset_launch_counts()
    fast_warp.warp_multi_pixel(x, *coords, spatial).sum().backward()
    assert fast_warp.launches["warp_bwd_dx"] == 1 and fast_warp.launches["warp_bwd_dgrid"] == 0
    torch.use_deterministic_algorithms(True)
    try:
        with pytest.raises(RuntimeError, match="deterministic"):
            fast_warp.warp_multi_pixel(x, *coords, spatial).sum().backward()
    finally:
        torch.use_deterministic_algorithms(False)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    x, coords, spatial = _case(0, 1, 2, 4, 4, 4, 2, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fast_warp.warp_multi_pixel_cuda(x.transpose(1, 2), *coords, spatial)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        fast_warp.warp_multi_pixel_cuda(x.half(), *coords, spatial)
    with pytest.raises(ValueError, match="cgy"):
        fast_warp.warp_multi_pixel_cuda(x, coords[0], coords[1].cpu(), coords[2], spatial)


def test_golden_pipeline_runs_through_the_kernel():
    z = np.load(golden.GOLDEN)
    variables = nested_from_flat({k[len("var/"):]: z[k] for k in z.files if k.startswith("var/")})
    cfg = tiny_config()
    models = build_models(cfg.model, device="cuda")
    for name, m in models.items():
        load_jax_variables(m, variables[name])
    pipe = InferencePipeline(cfg, models)
    enc = pipe.encode_source(torch.from_numpy(z["in/source"]).cuda())
    fast_warp.reset_launch_counts()
    out = pipe.drive_frame(*enc, torch.from_numpy(z["in/driving"]).cuda())
    assert fast_warp.launches == {"warp_fwd": 2, "warp_fwd_plain": 0, "warp_bwd_dgrid": 0,
                                  "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 0,
                                  "warp_bwd_dx_plain": 0}
    assert_close(out, z["out/drive"], 1e-4, "drive_frame")


def test_tiny_training_step_runs_through_the_kernels():
    """A tiny_config() step on the card: finite losses, each warp kernel
    launched twice (MFE and Generator), their plain versions never."""
    cfg = tiny_config()
    state = create_train_state(cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = tuple(torch.rand(2, 64, 64, 3, generator=g, device="cuda") for _ in range(4))
    fast_warp.reset_launch_counts()
    out = train_step(state, batch, generator=g)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in {**out["losses_g"], **out["losses_d"]}.values())
    assert fast_warp.launches == {"warp_fwd": 2, "warp_fwd_plain": 0, "warp_bwd_dgrid": 2,
                                  "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 2,
                                  "warp_bwd_dx_plain": 0}
