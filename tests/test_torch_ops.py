"""PyTorch port: geometry, heatmap, interpolate and motion ops against
facevae_tpu's on the CPU (same numpy inputs, atol 1e-5: fp32 values of order
1-20 that differ only in summation order); the port's import rule; and its
copy of the configuration dataclasses."""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import geometry as jg, heatmap as jh, interpolate as ji, motion as jm
from facevae_tpu_torch.ops import geometry as tg, heatmap as th, interpolate as ti, motion as tm
from torch_parity import ROOT, one_torch_thread, to_np  # noqa: F401

pytestmark = pytest.mark.fast
ATOL = 1e-5


def close(port, ref):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), rtol=0, atol=ATOL)


def T(a):
    return torch.from_numpy(np.array(a))


def _angles(rs, n=3):
    return [rs.uniform(-1.2, 1.2, n).astype(np.float32) for _ in range(3)]


_FORBIDDEN = ("jax", "jaxlib", "flax", "facevae_tpu", "serve", "evaluate")


def test_import_has_no_jax():
    """Every module of the port, and chip_smoke, import nothing of JAX and
    nothing of the JAX package (not even its JAX-free modules, such as
    facevae_tpu.config or the root serve.py and evaluate.py)."""
    code = ("import importlib, pkgutil, sys, facevae_tpu_torch, chip_smoke\n"
            "names = [m.name for m in pkgutil.walk_packages(facevae_tpu_torch.__path__, "
            "'facevae_tpu_torch.')]\n"
            "for n in names: importlib.import_module(n)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print(len(names))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert int(out) >= 30          # the walk found the port's modules


def test_config_copy_matches_the_jax_package():
    from facevae_tpu import config as jc
    from facevae_tpu_torch import config as tc
    assert dataclasses.asdict(tc.Config()) == dataclasses.asdict(jc.Config())
    assert dataclasses.asdict(tc.tiny_config()) == dataclasses.asdict(jc.tiny_config())
    for name in ("ModelConfig", "LossConfig", "TrainConfig", "DataConfig", "Config"):
        assert ([f.name for f in dataclasses.fields(getattr(tc, name))]
                == [f.name for f in dataclasses.fields(getattr(jc, name))]), name
    assert tc.ModelConfig().kp_spatial == jc.ModelConfig().kp_spatial


def test_pose_rotation(rng):
    y, p, r = _angles(rng)
    close(tg.pose_rotation(T(y), T(p), T(r)), jg.pose_rotation(y, p, r))


def test_transform_kp(rng):
    y, p, r = _angles(rng)
    kp = rng.uniform(-1, 1, (3, 5, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (3, 1, 1, 1)).astype(np.float32)
    for port, ref in zip(tg.transform_kp(T(kp), T(y), T(p), T(r), T(t), T(scale)),
                         jg.transform_kp(kp, y, p, r, t, scale)):
        close(port, ref)


def test_transform_kp_with_new_pose(rng):
    y, p, r = _angles(rng)
    ny, np_, nr = _angles(rng)
    kp = rng.uniform(-1, 1, (3, 5, 3)).astype(np.float32)
    t = rng.uniform(-0.3, 0.3, (3, 3)).astype(np.float32)
    delta = rng.uniform(-0.1, 0.1, (3, 5, 3)).astype(np.float32)
    port = tg.transform_kp_with_new_pose(T(kp), T(y), T(p), T(r), T(t), T(delta),
                                         T(ny), T(np_), T(nr))
    ref = jg.transform_kp_with_new_pose(kp, y, p, r, t, delta, ny, np_, nr)
    for a, b in zip(port, ref):
        close(a, b)


@pytest.mark.parametrize("spatial", [(7, 9), (4, 6, 5)])
def test_coordinate_grids(spatial):
    if len(spatial) == 2:
        close(tg.make_coordinate_grid_2d(spatial), jg.make_coordinate_grid_2d(spatial))
    else:
        close(tg.make_coordinate_grid_3d(spatial), jg.make_coordinate_grid_3d(spatial))


def test_heatmap_soft_argmax(rng):
    out = rng.randn(2, 4, 6, 5, 3).astype(np.float32)
    heat = th.out2heatmap_cl(T(out))
    close(heat, jh.out2heatmap_cl(out))
    close(th.heatmap2kp_cl(heat), jh.heatmap2kp_cl(jh.out2heatmap_cl(out)))


def test_kp2gaussian_3d(rng):
    kp = rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)
    close(th.kp2gaussian_3d_cl(T(kp), (4, 6, 5)), jh.kp2gaussian_3d_cl(kp, (4, 6, 5)))


@pytest.mark.parametrize("shapes", [((64, 64), (16, 16)), ((20, 30), (7, 11)),
                                    ((8, 8), (16, 16))])
def test_interpolate_bilinear(rng, shapes):
    (H, W), out_hw = shapes
    x = rng.rand(2, H, W, 3).astype(np.float32)
    port = ti.interpolate_bilinear_2d(T(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    close(port, ji.interpolate_bilinear_2d(jnp.asarray(x), out_hw))


def test_pools_and_upsamples(rng):
    x2 = rng.randn(2, 8, 6, 3).astype(np.float32)
    x3 = rng.randn(2, 3, 8, 6, 4).astype(np.float32)
    n2 = T(x2).permute(0, 3, 1, 2)
    n3 = T(x3).permute(0, 4, 1, 2, 3)
    cl2 = (0, 2, 3, 1)
    cl3 = (0, 2, 3, 4, 1)
    close(ti.max_pool_2d(n2, 3, 2, 1).permute(cl2), ji.max_pool_2d(jnp.asarray(x2), 3, 2, 1))
    close(ti.avg_pool_2d(n2, 2).permute(cl2), ji.avg_pool_2d(jnp.asarray(x2), 2))
    close(ti.avg_pool_3d(n3).permute(cl3), ji.avg_pool_3d(jnp.asarray(x3)))
    close(ti.upsample_nearest_2d(n2).permute(cl2), ji.upsample_nearest_2d(jnp.asarray(x2)))
    close(ti.upsample_nearest_3d(n3).permute(cl3), ji.upsample_nearest_3d(jnp.asarray(x3)))


def _motion_inputs(rng, N=2, K=3):
    kp_s = rng.uniform(-0.8, 0.8, (N, K, 3)).astype(np.float32)
    kp_d = rng.uniform(-0.8, 0.8, (N, K, 3)).astype(np.float32)
    Rs = np.asarray(jg.pose_rotation(*_angles(rng, N)))
    Rd = np.asarray(jg.pose_rotation(*_angles(rng, N)))
    return kp_s, kp_d, Rs, Rd


def test_heatmap_representations(rng):
    kp_s, kp_d, _, _ = _motion_inputs(rng)
    fs = np.zeros((2, 4, 6, 5, 2), np.float32)
    close(tm.create_heatmap_representations_cl(T(fs), T(kp_s), T(kp_d)),
          jm.create_heatmap_representations_cl(fs, kp_s, kp_d))


@pytest.mark.parametrize("include_identity", [True, False])
def test_affine_motion_and_pixel_coords(rng, include_identity):
    kp_s, kp_d, Rs, Rd = _motion_inputs(rng)
    jac, b = tm.motion_affine_params(T(kp_s), T(kp_d), T(Rs), T(Rd))
    rjac, rb = jm.motion_affine_params(kp_s, kp_d, Rs, Rd)
    close(jac, rjac)
    close(b, rb)
    spatial = (4, 6, 5)
    for port, ref in zip(tm.sparse_motion_pixel_coords(spatial, jac, b, include_identity),
                         jm.sparse_motion_pixel_coords(spatial, rjac, rb, include_identity)):
        close(port, ref)


def test_blend_deformation(rng):
    kp_s, kp_d, Rs, Rd = _motion_inputs(rng)
    logits = rng.randn(2, 4, 6, 5, 4).astype(np.float32)
    mask = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
    rjac, rb = jm.motion_affine_params(kp_s, kp_d, Rs, Rd)
    close(tm.blend_deformation(T(mask), T(np.asarray(rjac)), T(np.asarray(rb))),
          jm.blend_deformation(mask, rjac, rb))
