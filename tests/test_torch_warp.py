"""PyTorch port: the trilinear-warp forward against facevae_tpu's.

- the plain version (the CUDA kernel's reference) against JAX
  warp_multi_pixel / warp_single in fp32 (JAX on the CPU takes the exact
  gather path): 1e-5 of max|ref|, both are fp32 sums of 8 products;
- the plain version on bf16-rounded inputs against the Pallas kernel
  itself, run in interpret mode: 2% of max|ref|, the forward tolerance of
  tools/check_pallas_warp.py (the kernel rounds its one-hot weights and
  x-weighted products to bf16);
- the wrapper's dispatch rules (the kernel itself: tests/test_torch_cuda.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import fast_warp as jfw
from facevae_tpu.ops.pallas import warp_mm
from facevae_tpu_torch.ops import fast_warp as tfw
from torch_parity import assert_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.fast
FAR = np.array([-1e30, -1e6, -3.0, 1e6, 1e30], np.float32)


def _coords(rs, N, K1, spatial, size, motion):
    """[N,K1,NV] pixel coordinates per axis for a (D,H,W) volume: either a
    motion field (grid + noise, z-coherent so the Pallas z-band fits) or
    uniform over [-2, size+1]; 10% exact integers, 2% far outside."""
    Do, Ho, Wo = spatial
    NV = Do * Ho * Wo
    z, y, x = np.meshgrid(np.arange(Do), np.arange(Ho), np.arange(Wo), indexing="ij")
    grid = np.stack([x, y, z], -1).reshape(NV, 3)
    out = []
    for a in range(3):
        if motion:
            c = grid[:, a] * (size[a] - 1) / max(spatial[2 - a] - 1, 1)
            c = c[None, None] + rs.normal(0, 0.3, (N, K1, NV))
        else:
            c = rs.uniform(-2, size[a] + 1, (N, K1, NV))
        pick = rs.rand(N, K1, NV)
        c = np.where(pick < 0.1, np.round(c), c)
        c = np.where(pick > 0.98, rs.choice(FAR, c.shape), c)
        out.append(c.astype(np.float32))
    return out


def _case(rs, N=2, D=4, H=6, W=5, C=3, K1=3, spatial=None, motion=False):
    spatial = spatial or (D, H, W)
    x = rs.randn(N, D, H, W, C).astype(np.float32)
    return x, _coords(rs, N, K1, spatial, (W, H, D), motion), spatial


@pytest.mark.parametrize("shape", [dict(), dict(C=4, K1=1, spatial=(3, 7, 4)),
                                   dict(N=1, D=5, H=3, W=8, C=8, K1=2)])
def test_plain_matches_jax_fp32(rng, shape):
    x, (cgx, cgy, cgz), spatial = _case(rng, **shape)
    ref = jfw.warp_multi_pixel(jnp.asarray(x), cgx, cgy, cgz, spatial)
    port = tfw.warp_multi_pixel_plain(torch.from_numpy(x), *map(torch.from_numpy, (cgx, cgy, cgz)),
                                      spatial)
    assert_close(port, ref, 1e-5, "warp_multi_pixel")


def test_warp_single_matches_jax(rng):
    x = rng.randn(2, 4, 6, 5, 3).astype(np.float32)
    deformation = rng.uniform(-1.2, 1.2, (2, 4, 6, 5, 3)).astype(np.float32)
    ref = jfw.warp_single(jnp.asarray(x), jnp.asarray(deformation))
    port = tfw.warp_single(torch.from_numpy(x), torch.from_numpy(deformation))
    assert_close(port, ref, 1e-5, "warp_single")


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("zb", [None, 4])
def test_plain_matches_pallas_interpret(monkeypatch, rng, G, zb):
    monkeypatch.setattr(warp_mm.pl, "pallas_call",
                        functools.partial(warp_mm.pl.pallas_call, interpret=True))
    N, D, H, W, C, K1, VB = 1, 8, 16, 16, 4, 3, 512
    x, (cgx, cgy, cgz), spatial = _case(rng, N, D, H, W, C, K1, motion=True)
    xb = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    ref = warp_mm.warp_mm_fwd_multi_pallas(jfw._rows4(jnp.asarray(xb), G), cgx, cgy, cgz,
                                           D=D, H=H, W=W, Cg=C // G, K1=K1, G=G, VB=VB, zb=zb)
    port = tfw.warp_multi_pixel_plain(torch.from_numpy(xb),
                                      *map(torch.from_numpy, (cgx, cgy, cgz)), spatial)
    assert_close(port.reshape(N, -1, K1 * C), ref, 2e-2, f"Pallas G={G} zb={zb}")


def test_cpu_tensors_take_the_plain_version(rng):
    x, coords, spatial = _case(rng)
    tfw.reset_launch_counts()
    out = tfw.warp_multi_pixel(torch.from_numpy(x), *map(torch.from_numpy, coords), spatial)
    assert out.shape == (2, *spatial, 9)
    assert tfw.launches == {"warp_fwd": 0, "warp_fwd_plain": 1}


def test_plain_version_keeps_bf16_and_masks_inf(rng):
    x, coords, spatial = _case(rng)
    coords[0][0, 0, :4] = [np.inf, -np.inf, np.nan, 1e30]
    out = tfw.warp_multi_pixel_plain(torch.from_numpy(x).bfloat16(),
                                     *map(torch.from_numpy, coords), spatial)
    assert out.dtype == torch.bfloat16
    flat = out.float().reshape(2, -1, 9)
    assert torch.isfinite(flat).all()
    assert (flat[0, :4, :3] == 0).all()


def test_kernel_wrapper_refuses_cpu_tensors(rng):
    x, coords, spatial = _case(rng)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfw.warp_multi_pixel_cuda(torch.from_numpy(x), *map(torch.from_numpy, coords), spatial)


def test_autograd_is_not_ported(rng):
    x, coords, spatial = _case(rng)
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="Queue 2"):
        tfw.warp_multi_pixel(xt, *map(torch.from_numpy, coords), spatial)
    with torch.no_grad():
        tfw.warp_multi_pixel(xt, *map(torch.from_numpy, coords), spatial)


def test_shape_checks(rng):
    x, (cgx, cgy, cgz), spatial = _case(rng)
    args = [torch.from_numpy(a) for a in (x, cgx, cgy, cgz)]
    with pytest.raises(ValueError, match="voxels"):
        tfw.warp_multi_pixel(*args, (1, 2, 3))
    with pytest.raises(ValueError, match="differ"):
        tfw.warp_multi_pixel(args[0], args[1], args[2][:, :1], args[3], spatial)

