"""PyTorch port: the rotation conversions (facevae_tpu_torch/ops/rotations.py)
and the channel-first heatmap forms (out2heatmap, heatmap2kp,
kp2gaussian_2d in facevae_tpu_torch/ops/heatmap.py) against the JAX
package's, on the CPU.

Tolerances, max|err| <= REL * max|ref|: the rotations 1e-6 in fp32 (and in
float64, computed in the input's dtype: 1e-12); the heatmaps 1e-6 in fp32
and 2^-6 in bf16 (both round each step to bf16; the contractions and sums
may round in another order: two bf16 ulps at the largest value, 1.0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.ops import heatmap as jh, rotations as jr
from facevae_tpu_torch.ops import heatmap as th, rotations as tr
from torch_parity import assert_close, one_torch_thread  # noqa: F401

ROT = {np.float32: 1e-6, np.float64: 1e-12}
HEAT = {"float32": 1e-6, "bfloat16": 2.0 ** -6}


def _rvecs(rs, n, dtype):
    """Axis-angle vectors with angles in (0, pi), one zero vector (the eps
    guard) and one tiny one."""
    r = rs.randn(n, 3) * rs.uniform(0.05, 3.0, (n, 1)) / np.sqrt(3.0)
    r[0] = 0.0
    r[1] = 1e-9
    return r.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rotation_conversions(rng, dtype):
    """rodrigues, quaternion_to_matrix, matrix_to_quaternion (w >= 0),
    matrix_to_axisangle and axisangle_to_matrix on the same inputs; the
    port keeps the input's dtype."""
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        rel = ROT[dtype]
        r = _rvecs(rng, 64, dtype)
        q = rng.randn(64, 4).astype(dtype)

        @jax.jit
        def run(r, q):
            R = jr.rodrigues(r)
            axis, angle = jr.matrix_to_axisangle(R)
            return (R, jr.quaternion_to_matrix(q), jr.matrix_to_quaternion(R), axis, angle,
                    jr.axisangle_to_matrix(axis, angle))
        R, Rq, jq, jaxis, jangle, Ra = run(r, q)
        tR = tr.rodrigues(torch.from_numpy(r))
        assert tR.dtype == torch.from_numpy(r).dtype
        assert_close(tR, R, rel, "rodrigues")
        assert_close(tr.quaternion_to_matrix(torch.from_numpy(q)), Rq, rel, "quaternion_to_matrix")
        Rn = torch.tensor(np.asarray(R))
        tq = tr.matrix_to_quaternion(Rn)
        assert_close(tq, jq, rel, "matrix_to_quaternion")
        assert bool((tq[:, 0] >= 0).all())
        axis, angle = tr.matrix_to_axisangle(Rn)
        assert_close(axis, jaxis, rel, "axis")
        assert_close(angle, jangle, rel, "angle")
        assert_close(tr.axisangle_to_matrix(torch.tensor(np.asarray(jaxis)),
                                            torch.tensor(np.asarray(jangle))),
                     Ra, rel, "axisangle_to_matrix")
    finally:
        jax.config.update("jax_enable_x64", False)


def test_rotation_interp(rng):
    """Geodesic interpolation at several alphas (a scalar and a per-row
    vector), ends included."""
    R0, R1 = (tr.rodrigues(torch.from_numpy(_rvecs(rng, 32, np.float32))) for _ in range(2))
    interp = jax.jit(jr.rotation_interp)
    for alpha in (0.0, 0.3, 1.0, rng.uniform(0, 1, 32).astype(np.float32)):
        ta = torch.from_numpy(alpha) if isinstance(alpha, np.ndarray) else alpha
        assert_close(tr.rotation_interp(R0, R1, ta), interp(R0.numpy(), R1.numpy(), alpha),
                     ROT[np.float32], f"rotation_interp alpha={alpha}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_first_heatmaps(rng, dtype):
    """out2heatmap (softmax in the input's dtype), heatmap2kp (grid in the
    heatmap's dtype) and kp2gaussian_2d, each in ``dtype``."""
    rel = HEAT[dtype]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    out = (rng.randn(2, 5, 4, 6, 7) * 3).astype(np.float32)
    kp2 = rng.uniform(-1, 1, (2, 5, 2)).astype(np.float32)
    j_heat, j_kp, j_g = (np.asarray(a, np.float32) for a in jax.jit(lambda o, k: (
        jh.out2heatmap(o), jh.heatmap2kp(o), jh.kp2gaussian_2d(k, (9, 7))))(
        jnp.asarray(out, jd), jnp.asarray(kp2, jd)))
    t_heat = th.out2heatmap(torch.from_numpy(out).to(td))
    assert t_heat.dtype == td
    assert_close(t_heat.float(), j_heat, rel, "out2heatmap")
    kp = th.heatmap2kp(torch.from_numpy(out).to(td))
    assert kp.dtype == td
    assert_close(kp.float(), j_kp, rel, "heatmap2kp")
    g = th.kp2gaussian_2d(torch.from_numpy(kp2).to(td), (9, 7))
    assert g.dtype == td and g.shape == (2, 5, 9, 7)
    assert_close(g.float(), j_g, rel, "kp2gaussian_2d")
