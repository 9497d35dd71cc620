"""On-device augmentation (counterpart of facevae_tpu/data/device_aug.py).

The reference's CPU pipeline (rotation, cv2.warpPerspective, PIL colour
jitter: data/augmentation.py) runs here on the training device instead:
rotation and random perspective collapse into one 3x3 homography per frame,
the frame is warped once through the multi-grid warp at D = 1 (kernel 1 on
the card), then brightness / saturation / hue / contrast jitter runs as
tensor ops in a fixed order in fp32.  Functionally equal to the CPU path,
not bit-equal (one interpolation instead of two, no uint8 round trip).

Two parts, so that a test can inject draws that JAX made:

  frame_draws(generator, n, size, cfg)   the per-frame random draws
  apply_augmentation(frames, draws, cfg) everything else

augment_batch(generator, frames, cfg) is the two in a row.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.config import DataConfig
from portbench.reference.numerics import constant
from portbench.reference.warp import warp_multi_pixel

_LUMA = (0.299, 0.587, 0.114)


class FrameDraws(NamedTuple):
    """Per-frame draws of one batch of N frames, on the frames' device."""
    homography: torch.Tensor   # [N,3,3] fp32, source pixel coords -> output pixel coords
    brightness: torch.Tensor   # [N] fp32 factor
    saturation: torch.Tensor   # [N] fp32 factor
    hue: torch.Tensor          # [N] fp32 shift, in turns
    contrast: torch.Tensor     # [N] fp32 factor
    flip: torch.Tensor         # [N] bool; applied where cfg.use_flip is set


def _solve_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """DLT for 4 point pairs, batched: H [N,3,3] with dst ~ H @ src, from
    src / dst [N,4,2] (the JAX module's rows, in its order)."""
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    row_u = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    row_v = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([row_u, row_v], 2).reshape(-1, 8, 8)
    b = torch.stack([u, v], -1).reshape(-1, 8, 1)
    h = torch.linalg.solve_ex(a, b)[0][..., 0]       # _ex: no host sync on the card
    return torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(-1, 3, 3)


def _perspective_homography(pers: torch.Tensor, enl: torch.Tensor, size: int) -> torch.Tensor:
    """Corner-perturbation homographies (reference augmentation.py:338-349
    geometry: one corner pair sheared by pers, all enlarged by enl), from
    the signed magnitudes pers, enl [N]."""
    s = float(size)
    corners = constant(((0.0, 0.0), (0.0, 1.0), (1.0, 0.0), (1.0, 1.0)), device=pers.device) * s
    signs = constant(((-1.0, -1.0), (-1.0, 1.0), (1.0, -1.0), (1.0, 1.0)), device=pers.device)
    src = corners + signs * enl[:, None, None]
    dst = src.clone()
    dst[:, 1, 0] += pers
    dst[:, 3, 0] -= pers
    return _solve_homography(src, dst)


def _rotation_homography(angle: torch.Tensor, size: int) -> torch.Tensor:
    """Rotations by angle [N] (radians) about the image centre, [N,3,3]."""
    c, si = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    cx = cy = (size - 1) / 2.0
    t1 = constant(((1.0, 0.0, -cx), (0.0, 1.0, -cy), (0.0, 0.0, 1.0)), device=angle.device)
    r = torch.stack([c, -si, zero, si, c, zero, zero, zero, one], -1).reshape(-1, 3, 3)
    t2 = constant(((1.0, 0.0, cx), (0.0, 1.0, cy), (0.0, 0.0, 1.0)), device=angle.device)
    return t2 @ r @ t1


def frame_draws(generator, n: int, size: int, cfg: DataConfig, device=None) -> FrameDraws:
    """The draws of n frames of size x size: ONE uniform [n, 10] draw from
    ``generator`` (a torch.Generator on ``device``, default its own; None:
    torch's default generator of ``device``), whose columns are, in order, the
    rotation angle, the perspective shear and enlargement magnitudes and
    their two signs, brightness, saturation, hue shift, contrast and the
    flip; the ranges are the JAX module's (_frame_draws, _color_jitter)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    u = torch.rand(n, 10, generator=generator, device=device).unbind(1)
    rel = size / 256.0                 # reference magnitudes assume 256px inputs

    def uniform(col, lo, hi):                 # jax.random.uniform's fp32 arithmetic
        lo, hi = (constant(v, device=col.device) for v in (lo, hi))
        return col * (hi - lo) + lo

    sign = lambda col: torch.where(col < 0.5, 1.0, -1.0)            # noqa: E731
    deg = cfg.rotation_degrees
    angle = uniform(u[0], -deg, deg) * math.pi / 180.0
    pers = uniform(u[1], 20.0, float(max(21, cfg.pers_num))) * rel * sign(u[3])
    enl = uniform(u[2], 20.0, float(max(21, cfg.enlarge_num))) * rel * sign(u[4])
    j = cfg.jitter
    return FrameDraws(
        homography=_perspective_homography(pers, enl, size) @ _rotation_homography(angle, size),
        brightness=uniform(u[5], 1 - j, 1 + j), saturation=uniform(u[6], 1 - j, 1 + j),
        hue=uniform(u[7], -j, j), contrast=uniform(u[8], 1 - j, 1 + j), flip=u[9] < 0.5)


def _warp_coords(H: torch.Tensor, h: int, w: int):
    """Source pixel coordinates (x, y), each [N, h*w] fp32, of homographies
    H [N,3,3] (output <- source), clamped to the image (cv2
    BORDER_REPLICATE), so that border padding is plain interior sampling."""
    hinv = torch.linalg.inv_ex(H)[0]
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=H.device),
                            torch.arange(w, dtype=torch.float32, device=H.device),
                            indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    src = pts @ hinv.transpose(1, 2)
    src = src[..., :2] / src[..., 2:3]
    return src[..., 0].clamp(0.0, float(w - 1)), src[..., 1].clamp(0.0, float(h - 1))


def _warp_batch(frames: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """[N,H,W,C] sampled at pixel coordinates gx, gy [N, H*W] through
    warp_multi_pixel as [N,1,H,W,C] at K1 = 1: kernel 1 on the card, its
    plain version on the CPU.  Result in the frames' dtype."""
    N, h, w, C = frames.shape
    # facevae_tpu/data/device_aug.py:114-115: the rows go through the warp in
    # bf16 where the TPU path has a Pallas plan (on its chip); elsewhere JAX
    # takes its fp32 gather.  Here: bf16 on the card, fp32 on the CPU.
    rows = frames.to(torch.bfloat16 if frames.is_cuda else torch.float32)[:, None]
    gx, gy = gx[:, None].contiguous(), gy[:, None].contiguous()
    out = warp_multi_pixel(rows, gx, gy, torch.zeros_like(gx), (1, h, w))
    return out.reshape(N, h, w, C).to(frames.dtype)


def _rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(delta, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = (i.to(torch.int64) % 6)[..., None]
    pick = lambda *c: torch.gather(torch.stack(c, -1), -1, i)[..., 0]   # noqa: E731
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], -1)


def _color_jitter(x: torch.Tensor, draws: FrameDraws) -> torch.Tensor:
    """Brightness, saturation, hue, contrast of [N,H,W,3] in [0,1], in that
    fixed order (the JAX module's _color_jitter)."""
    col = lambda a: a[:, None, None, None]                            # noqa: E731
    luma = constant(tuple(_LUMA), x.dtype, x.device)
    x = x * col(draws.brightness)
    lum = (x @ luma)[..., None]
    x = lum + col(draws.saturation) * (x - lum)
    h, s, v = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    x = _hsv_to_rgb((h + draws.hue[:, None, None]) % 1.0, s, v)
    mean_l = col((x @ luma).mean(dim=(1, 2)))
    x = mean_l + col(draws.contrast) * (x - mean_l)
    return torch.clamp(x, 0.0, 1.0)


def apply_augmentation(frames: torch.Tensor, draws: FrameDraws, cfg: DataConfig) -> torch.Tensor:
    """Frames [N,H,W,3] float in [0,1] -> their augmented copies: the
    homography warp, the colour jitter, the flip where cfg.use_flip."""
    _, h, w, _ = frames.shape
    gx, gy = _warp_coords(draws.homography, h, w)
    out = _color_jitter(_warp_batch(frames, gx, gy), draws)
    if cfg.use_flip:
        out = torch.where(draws.flip[:, None, None, None], out.flip(2), out)
    return out


def augment_batch(generator, frames: torch.Tensor, cfg: DataConfig) -> torch.Tensor:
    """[N,H,W,3] -> [N,H,W,3] with independent per-frame draws from
    ``generator`` (frame_draws)."""
    draws = frame_draws(generator, frames.shape[0], frames.shape[1], cfg, frames.device)
    return apply_augmentation(frames, draws, cfg)
