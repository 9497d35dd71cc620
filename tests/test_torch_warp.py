"""PyTorch port: the trilinear warp and its gradient against facevae_tpu's.

- the plain forward (the CUDA kernel's reference) against JAX
  warp_multi_pixel / warp_single in fp32 (JAX on the CPU takes the exact
  gather path): 1e-5 of max|ref|, both are fp32 sums of 8 products;
- the plain backward against jax.vjp of warp_multi_pixel in fp32, dx and
  dgx/dgy/dgz: 1e-5 of max|ref| (fp32 sums of the same products in another
  order), with exact integers, the last index and far-out coordinates;
- the plain versions on bf16-rounded inputs against the Pallas kernels
  themselves, run in interpret mode: 2% of max|ref| forward, 3% for dx and
  dgrid, the tolerances of tools/check_pallas_warp.py (the kernels round
  their one-hot weights and x-weighted products to bf16);
- torch.autograd.gradcheck of the plain version in fp64;
- the wrappers' dispatch rules (the kernels themselves: test_torch_cuda.py).
"""
import functools

import jax
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
    assert tfw.launches == {"warp_fwd": 0, "warp_fwd_plain": 1, "warp_bwd_dgrid": 0,
                            "warp_bwd_dgrid_plain": 0, "warp_bwd_dx": 0, "warp_bwd_dx_plain": 0}


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


def _edge_case(rng, N=2, D=5, H=9, W=5, C=3, K1=3, spatial=(3, 4, 5)):
    """Coordinates for the backward: sizes with size-1 a power of two, so
    JAX's pixel -> normalized -> pixel round trip on the CPU keeps exact
    integers exact (torch's floor subgradient then picks the same corners
    on both sides); uniform over [-2, size+1] with 15% exact integers, 5%
    the last index size-1 and 3% finite far-out values."""
    x = rng.randn(N, D, H, W, C).astype(np.float32)
    NV = int(np.prod(spatial))
    coords = []
    for size in (W, H, D):
        c = rng.uniform(-2, size + 1, (N, K1, NV))
        pick = rng.rand(N, K1, NV)
        c = np.where(pick < 0.15, np.round(c), c)
        c = np.where((pick >= 0.15) & (pick < 0.2), size - 1.0, c)
        c = np.where(pick > 0.97, rng.choice(FAR, c.shape), c)
        coords.append(c.astype(np.float32))
    gout = rng.randn(N, *spatial, K1 * C).astype(np.float32)
    return x, coords, gout, spatial


def test_plain_backward_matches_jax_vjp(rng):
    x, coords, gout, spatial = _edge_case(rng)
    _, vjp = jax.vjp(lambda *a: jfw.warp_multi_pixel(*a, spatial), jnp.asarray(x),
                     *map(jnp.asarray, coords))
    rdx, *rdgrid = vjp(jnp.asarray(gout))
    dx, dgrid = tfw.warp_multi_pixel_bwd_plain(torch.from_numpy(x), *map(torch.from_numpy, coords),
                                               torch.from_numpy(gout), spatial)
    assert_close(dx, rdx, 1e-5, "dx")
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert_close(d, r, 1e-5, f"dgrid {'xyz'[a]}")


def test_autograd_function_matches_jax_vjp(rng):
    """warp_multi_pixel under autograd (the CPU takes the plain versions),
    and warp_single's chain rule back to the normalized grid."""
    x, coords, gout, spatial = _edge_case(rng, K1=1, spatial=(5, 9, 5))
    xt, *ct = (torch.from_numpy(a).requires_grad_() for a in (x, *coords))
    tfw.reset_launch_counts()
    (tfw.warp_multi_pixel(xt, *ct, spatial) * torch.from_numpy(gout)).sum().backward()
    assert tfw.launches == {"warp_fwd": 0, "warp_fwd_plain": 1, "warp_bwd_dgrid": 0,
                            "warp_bwd_dgrid_plain": 1, "warp_bwd_dx": 0, "warp_bwd_dx_plain": 1}
    _, vjp = jax.vjp(lambda *a: jfw.warp_multi_pixel(*a, spatial), jnp.asarray(x),
                     *map(jnp.asarray, coords))
    for t, r, what in zip((xt, *ct), vjp(jnp.asarray(gout)), ("dx", "dgx", "dgy", "dgz")):
        assert_close(t.grad, r, 1e-5, what)
    deformation = rng.uniform(-1.2, 1.2, (2, 5, 9, 5, 3)).astype(np.float32)
    dt = torch.from_numpy(deformation).requires_grad_()
    xt.grad = None
    (tfw.warp_single(xt, dt) * torch.from_numpy(gout)).sum().backward()
    _, vjp = jax.vjp(jfw.warp_single, jnp.asarray(x), jnp.asarray(deformation))
    rdx, rdd = vjp(jnp.asarray(gout))
    assert_close(xt.grad, rdx, 1e-5, "warp_single dx")
    assert_close(dt.grad, rdd, 1e-5, "warp_single d deformation")


def test_backward_skips_what_autograd_does_not_need(rng):
    x, coords, gout, spatial = _edge_case(rng)
    xt = torch.from_numpy(x).requires_grad_()
    tfw.reset_launch_counts()
    tfw.warp_multi_pixel(xt, *map(torch.from_numpy, coords), spatial).sum().backward()
    assert (tfw.launches["warp_bwd_dx_plain"], tfw.launches["warp_bwd_dgrid_plain"]) == (1, 0)
    ct = [torch.from_numpy(c).requires_grad_() for c in coords]
    tfw.warp_multi_pixel(torch.from_numpy(x), *ct, spatial).sum().backward()
    assert (tfw.launches["warp_bwd_dx_plain"], tfw.launches["warp_bwd_dgrid_plain"]) == (1, 1)
    with torch.no_grad():
        tfw.warp_multi_pixel(xt, *map(torch.from_numpy, coords), spatial)


def test_plain_backward_gradcheck_fp64(rng):
    """The plain version's backward is the derivative of its forward, in
    fp64, away from integer coordinates (where the subgradient jumps)."""
    x = torch.from_numpy(rng.randn(1, 3, 4, 5, 2)).requires_grad_()
    spatial = (2, 2, 3)
    coords = [torch.from_numpy(np.round(rng.uniform(-1.5, s + 0.5, (1, 2, 12)), 1) + 0.05)
              .requires_grad_() for s in (5, 4, 3)]
    assert torch.autograd.gradcheck(lambda *a: tfw.warp_multi_pixel(*a, spatial), (x, *coords))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("zb", [None, 4])
def test_plain_backward_matches_pallas_interpret(monkeypatch, rng, G, zb):
    monkeypatch.setattr(warp_mm.pl, "pallas_call",
                        functools.partial(warp_mm.pl.pallas_call, interpret=True))
    N, D, H, W, C, K1 = 1, 8, 16, 16, 4, 3
    x, (cgx, cgy, cgz), spatial = _case(rng, N, D, H, W, C, K1, motion=True)
    gout = rng.randn(N, *spatial, K1 * C).astype(np.float32)
    xb, gb = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in (x, gout))
    drows, *rdgrid = warp_mm.warp_mm_bwd_multi_pallas(
        jfw._rows4(jnp.asarray(xb), G), cgx, cgy, cgz, jnp.asarray(gb.reshape(N, -1, K1 * C)),
        D=D, H=H, W=W, Cg=C // G, K1=K1, G=G, VB_DGRID=512, VB_DROWS=512, zb=zb)
    rdx = np.asarray(drows).reshape(N, G, D, H, C // G, W).transpose(0, 2, 3, 5, 1, 4)
    dx, dgrid = tfw.warp_multi_pixel_bwd_plain(torch.from_numpy(xb),
                                               *map(torch.from_numpy, (cgx, cgy, cgz)),
                                               torch.from_numpy(gb), spatial)
    assert_close(dx, rdx.reshape(x.shape), 3e-2, f"Pallas dx G={G} zb={zb}")
    for a, (d, r) in enumerate(zip(dgrid, rdgrid)):
        assert_close(d, r, 3e-2, f"Pallas dgrid {'xyz'[a]} G={G} zb={zb}")


def test_shape_checks(rng):
    x, (cgx, cgy, cgz), spatial = _case(rng)
    args = [torch.from_numpy(a) for a in (x, cgx, cgy, cgz)]
    with pytest.raises(ValueError, match="voxels"):
        tfw.warp_multi_pixel(*args, (1, 2, 3))
    with pytest.raises(ValueError, match="differ"):
        tfw.warp_multi_pixel(args[0], args[1], args[2][:, :1], args[3], spatial)

