"""PyTorch port: the on-device augmentation (data/device_aug.py) and the
step's fused-aug mode, against the JAX package, on the CPU.

- apply_augmentation against facevae_tpu.data.device_aug.augment_batch on
  the same frames, with the draws JAX made injected (the test replays
  _frame_draws and _color_jitter's 4-way key split in JAX): within 1e-5 of
  max|ref| in fp32, at several sizes and with use_flip on.  JAX on the CPU
  warps through its fp32 grid_sample on normalized coordinates (no Pallas
  plan there), the port through the multi-grid warp's fp32 plain version
  on pixel coordinates: the coordinates round differently in the last
  bits, hence a tolerance.
- frame_draws: the homography (1e-6 of max|ref|: the two packages' LU
  solves) and the jitter factors (bit for bit) it builds from its uniforms
  equal what the JAX module builds from the same uniforms (jax.random
  patched to hand them out in its draw order).
- On the CPU the warp is the multi-grid warp's plain version in fp32 (one
  launch a batch), as JAX on the CPU takes its fp32 path.
- train_step(fused_aug=True) on uint8 frames equals, bit for bit, the
  four-tuple step on the views that augment_batch makes from the same
  generator: the same losses, aux and updated parameters.  With the two
  checks above this holds the fused step to JAX without compiling JAX's.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facevae_tpu.config import DataConfig as JaxDataConfig
from facevae_tpu.data import device_aug as jda
from facevae_tpu_torch.config import DataConfig, tiny_config
from facevae_tpu_torch.data import device_aug
from facevae_tpu_torch.ops import fast_warp
from facevae_tpu_torch.train import build_all_modules, create_train_state, train_step
from torch_parity import assert_close, one_torch_thread  # noqa: F401

REL = 1e-5


def _frames(size, n, seed):
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:size, :size] / size
    out = []
    for _ in range(n):
        f, p = rs.uniform(2, 6, (2, 3)), rs.uniform(0, 6, 3)
        img = np.stack([0.5 + 0.4 * np.sin(f[0, c] * x + p[c]) * np.cos(f[1, c] * y + p[c])
                        for c in range(3)], -1)
        out.append(np.clip(img + rs.uniform(-0.03, 0.03, img.shape), 0, 1))
    return np.stack(out).astype(np.float32)


def _jax_draws(key, n, size, cfg):
    """augment_batch's per-frame draws, replayed in JAX."""
    def one(k):
        H, k_jit, k_flip = jda._frame_draws(k, size, cfg)
        kb, ks, kh, kc = jax.random.split(k_jit, 4)
        j = cfg.jitter
        return (H, jax.random.uniform(kb, (), minval=1 - j, maxval=1 + j),
                jax.random.uniform(ks, (), minval=1 - j, maxval=1 + j),
                jax.random.uniform(kh, (), minval=-j, maxval=j),
                jax.random.uniform(kc, (), minval=1 - j, maxval=1 + j),
                jax.random.bernoulli(k_flip))
    cols = jax.jit(jax.vmap(one))(jax.random.split(key, n))
    return device_aug.FrameDraws(*(torch.from_numpy(np.array(c)) for c in cols))


@pytest.mark.parametrize("size, flip", [(16, False), (32, False), (64, False), (48, True)])
def test_apply_augmentation_matches_jax(size, flip):
    n = 4
    frames = _frames(size, n, size)
    key = jax.random.PRNGKey(size + 1)
    ref = np.asarray(jax.jit(jda.augment_batch, static_argnums=2)(
        key, jnp.asarray(frames), JaxDataConfig(use_flip=flip)))
    draws = _jax_draws(key, n, size, JaxDataConfig(use_flip=flip))
    if flip:
        assert 0 < int(draws.flip.sum()) < n          # both branches of the flip
    out = device_aug.apply_augmentation(torch.from_numpy(frames), draws,
                                        DataConfig(use_flip=flip))
    assert out.dtype == torch.float32
    assert_close(out, ref, REL, f"augmentation {size}px flip={flip}")


def test_frame_draws_match_the_jax_formulas(monkeypatch):
    """The port's draws of n frames, and JAX's _frame_draws / jitter ranges
    fed the same uniforms in the order JAX draws them (perspective shear,
    enlargement, their signs, then the angle; b, s, hue, c)."""
    n, cfg = 5, DataConfig(rotation_degrees=25.0, pers_num=33, enlarge_num=44, jitter=0.2)
    jcfg = JaxDataConfig(rotation_degrees=25.0, pers_num=33, enlarge_num=44, jitter=0.2)
    for size in (64, 256):
        draws = device_aug.frame_draws(torch.Generator().manual_seed(size), n, size, cfg)
        u = torch.rand(n, 10, generator=torch.Generator().manual_seed(size)).numpy()
        for i in range(n):
            queue = [u[i, 1], u[i, 2], u[i, 3], u[i, 4], u[i, 0]]

            def uniform(key, shape=(), minval=0.0, maxval=1.0):
                return jnp.float32(queue.pop(0)) * (jnp.float32(maxval) - jnp.float32(minval)) \
                    + jnp.float32(minval)

            fake = types.SimpleNamespace(split=lambda key, num=2: [key] * num, uniform=uniform,
                                         bernoulli=lambda key: queue.pop(0) < 0.5)
            monkeypatch.setattr(jda, "jax", types.SimpleNamespace(random=fake))
            H, _, _ = jda._frame_draws(None, size, jcfg)
            monkeypatch.undo()
            assert not queue
            assert_close(draws.homography[i], np.asarray(H), 1e-6, f"homography {size} {i}")
            j = jcfg.jitter
            for name, col, lo, hi in (("brightness", 5, 1 - j, 1 + j),
                                      ("saturation", 6, 1 - j, 1 + j), ("hue", 7, -j, j),
                                      ("contrast", 8, 1 - j, 1 + j)):
                want = u[i, col] * (np.float32(hi) - np.float32(lo)) + np.float32(lo)
                assert getattr(draws, name)[i].numpy() == want, name
            assert bool(draws.flip[i]) == (u[i, 9] < 0.5)


def test_the_cpu_warp_is_the_fp32_plain_version(monkeypatch):
    seen = []
    real = device_aug.warp_multi_pixel

    def spy(x, *args):
        seen.append(x.dtype)
        return real(x, *args)

    monkeypatch.setattr(device_aug, "warp_multi_pixel", spy)
    fast_warp.reset_launch_counts()
    out = device_aug.augment_batch(torch.Generator().manual_seed(0),
                                   torch.from_numpy(_frames(24, 3, 1)), DataConfig())
    assert seen == [torch.float32] and out.shape == (3, 24, 24, 3)
    assert fast_warp.launches["warp_fwd_plain"] == 1 and fast_warp.launches["warp_fwd"] == 0
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


def test_fused_step_equals_the_unfused_step_on_its_views():
    cfg = tiny_config()
    size = cfg.model.image_size
    rs = np.random.RandomState(3)
    s8, d8 = (torch.from_numpy(rs.randint(0, 256, (2, size, size, 3)).astype(np.uint8))
              for _ in range(2))
    fused = create_train_state(cfg, "cpu", build_all_modules(cfg, "cpu"))
    plain = create_train_state(cfg, "cpu", build_all_modules(cfg, "cpu"))
    out = train_step(fused, (s8, d8), generator=torch.Generator().manual_seed(5),
                     fused_aug=True)
    g = torch.Generator().manual_seed(5)
    s, d = s8.float() / 255.0, d8.float() / 255.0
    views = (device_aug.augment_batch(g, s, cfg.data), device_aug.augment_batch(g, d, cfg.data))
    ref = train_step(plain, (s, d, *views), generator=g)
    for part in ("losses_g", "losses_d", "aux"):
        for k, v in ref[part].items():
            assert torch.equal(out[part][k], v), f"{part}.{k}"
    for name in ("afe", "generator", "discriminator"):
        for (k, a), b in zip(fused.nets[name].state_dict().items(),
                             plain.nets[name].state_dict().values()):
            assert torch.equal(a, b), f"{name}.{k}"
    assert fused.step == plain.step == 1
