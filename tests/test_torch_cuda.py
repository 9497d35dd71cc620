"""PyTorch port on the card: the CUDA warp kernel against its plain
version, the wrapper's refusals, and the tiny golden pipeline through the
kernel.  Every test skips without a CUDA device.

This file imports no JAX, so it also runs on a machine without it:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from facevae_tpu.config import tiny_config
from facevae_tpu_torch.convert import load_jax_variables, nested_from_flat
from facevae_tpu_torch.models import build_models
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train.inference import InferencePipeline
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
    assert fast_warp.launches == {"warp_fwd": 2, "warp_fwd_plain": 0}
    assert_close(out, z["out/drive"], 1e-4, "drive_frame")
