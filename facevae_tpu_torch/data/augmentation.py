"""CPU augmentation (a copy of facevae_tpu/data/augmentation.py, not an
import of it: the port imports nothing of the JAX package).  It draws from
Python's ``random`` and numpy's global RNG in the original's order, so that
seeded runs of the two give the same frames bit for bit.

Clip-consistent transforms (same random params across frames of a clip)
feeding ONLY the contrastive branch (reference dataset.py:121-129).  Active
default pipeline (dataset.py:52-57): rotation ±30° -> perspective warp ->
color jitter (b/c/s/h = 0.1).  Flip/resize/crop/blur/grayscale are present
but disabled by default, as in the reference (augmentation.py:408-412).

Implementation notes vs the reference:
  - rotation uses cv2.warpAffine (bilinear, constant 0 border) instead of
    skimage.transform.rotate — same geometry, interpolation differs at the
    last bit.
  - color jitter mirrors the torchvision PIL path including the
    float->uint8->PIL->uint8->float roundtrip (quantization is part of the
    reference's data distribution).
  - perspective keeps the reference's hardcoded 256 output size when the
    input is 256; otherwise it uses the input size (the reference only ever
    ran 256², augmentation.py:341).
"""
from __future__ import annotations

import random
import numbers
from typing import List

import numpy as np
import cv2
from PIL import Image, ImageEnhance, ImageFilter


def _as_ubyte(img: np.ndarray) -> np.ndarray:
    """skimage.img_as_ubyte parity for float [0,1] input."""
    if img.dtype == np.uint8:
        return img
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def _as_float(img: np.ndarray) -> np.ndarray:
    """skimage.img_as_float parity for uint8 input."""
    if img.dtype == np.uint8:
        return img.astype(np.float64) / 255.0
    return img


class RandomFlip:
    def __init__(self, time_flip=False, horizontal_flip=False):
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip):
        if random.random() < 0.5 and self.time_flip:
            return clip[::-1]
        if random.random() < 0.5 and self.horizontal_flip:
            return [np.fliplr(img) for img in clip]
        return clip


class RandomRotation:
    def __init__(self, degrees):
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def __call__(self, clip):
        angle = random.uniform(self.degrees[0], self.degrees[1])
        out = []
        for img in clip:
            h, w = img.shape[:2]
            m = cv2.getRotationMatrix2D((w / 2 - 0.5, h / 2 - 0.5), angle, 1.0)
            out.append(cv2.warpAffine(img.astype(np.float32), m, (w, h),
                                      flags=cv2.INTER_LINEAR,
                                      borderMode=cv2.BORDER_CONSTANT, borderValue=0))
        return out


class RandomPerspective:
    """Per-frame random perspective (reference augmentation.py:315-353)."""

    def __init__(self, pers_num, enlarge_num):
        self.pers_num = pers_num
        self.enlarge_num = enlarge_num

    def __call__(self, clip):
        out = list(clip)
        for i in range(len(clip)):
            h, w = clip[i].shape[:2]
            # the reference magnitudes assume 256px inputs; scale for others
            # (at 64px an unscaled ±40px corner shift degenerates the homography)
            rel = h / 256.0
            pers_size = np.random.randint(20, self.pers_num) * (-1) ** np.random.randint(2) * rel
            enlarge_size = np.random.randint(20, self.enlarge_num) * (-1) ** np.random.randint(2) * rel
            crop_size = 256 if (h, w) == (256, 256) else h
            dst = np.array([
                [-enlarge_size, -enlarge_size],
                [-enlarge_size + pers_size, w + enlarge_size],
                [h + enlarge_size, -enlarge_size],
                [h + enlarge_size - pers_size, w + enlarge_size]], dtype=np.float32)
            src = np.array([
                [-enlarge_size, -enlarge_size], [-enlarge_size, w + enlarge_size],
                [h + enlarge_size, -enlarge_size], [h + enlarge_size, w + enlarge_size]],
                dtype=np.float32)
            m = cv2.getPerspectiveTransform(src, dst)
            out[i] = cv2.warpPerspective(clip[i].astype(np.float32), m,
                                         (crop_size, crop_size),
                                         borderMode=cv2.BORDER_REPLICATE)
        return out


class ColorJitter:
    """torchvision-functional jitter via PIL, clip-consistent params
    (reference augmentation.py:216-312)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    @staticmethod
    def _adjust_hue(img: Image.Image, factor: float) -> Image.Image:
        if factor == 0:
            return img
        h, s, v = img.convert("HSV").split()
        h_np = np.array(h, dtype=np.uint8)
        h_np = (h_np.astype(np.int16) + int(factor * 255)) % 256
        h = Image.fromarray(h_np.astype(np.uint8), "L")
        return Image.merge("HSV", (h, s, v)).convert("RGB")

    def __call__(self, clip):
        b = random.uniform(max(0, 1 - self.brightness), 1 + self.brightness) if self.brightness > 0 else None
        c = random.uniform(max(0, 1 - self.contrast), 1 + self.contrast) if self.contrast > 0 else None
        s = random.uniform(max(0, 1 - self.saturation), 1 + self.saturation) if self.saturation > 0 else None
        hfac = random.uniform(-self.hue, self.hue) if self.hue > 0 else None

        ops = []
        if b is not None:
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(b))
        if s is not None:
            ops.append(lambda im: ImageEnhance.Color(im).enhance(s))
        if hfac is not None:
            ops.append(lambda im: self._adjust_hue(im, hfac))
        if c is not None:
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(c))
        random.shuffle(ops)

        out = []
        for img in clip:
            pil = Image.fromarray(_as_ubyte(img))
            for op in ops:
                pil = op(pil)
            out.append(_as_float(np.array(pil)).astype(np.float32))
        return out


class RandomResize:
    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0), interpolation="nearest"):
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, clip):
        scale = random.uniform(self.ratio[0], self.ratio[1])
        h, w = clip[0].shape[:2]
        new_w, new_h = int(w * scale), int(h * scale)
        interp = cv2.INTER_LINEAR if self.interpolation == "bilinear" else cv2.INTER_NEAREST
        return [cv2.resize(img.astype(np.float32), (new_w, new_h), interpolation=interp)
                for img in clip]


class RandomCrop:
    def __init__(self, size):
        if isinstance(size, numbers.Number):
            size = (size, size)
        self.size = size

    def __call__(self, clip):
        h, w = self.size
        im_h, im_w = clip[0].shape[:2]
        pad_h = max(0, h - im_h)
        pad_w = max(0, w - im_w)
        if pad_h or pad_w:
            clip = [np.pad(img, ((pad_h // 2, (pad_h + 1) // 2),
                                 (pad_w // 2, (pad_w + 1) // 2), (0, 0)), mode="edge")
                    for img in clip]
            im_h, im_w = clip[0].shape[:2]
        x1 = 0 if h == im_h else random.randint(0, im_w - w)
        y1 = 0 if w == im_w else random.randint(0, im_h - h)
        return [img[y1:y1 + h, x1:x1 + w] for img in clip]


class GaussianBlur:
    """SimCLR-style random blur (reference augmentation.py:356-370; disabled
    by default upstream)."""

    def __init__(self, sigma=(0.1, 2.0)):
        self.sigma = sigma

    def __call__(self, clip):
        out = []
        for img in clip:
            if random.random() < 0.5:
                s = random.uniform(self.sigma[0], self.sigma[1])
                pil = Image.fromarray(_as_ubyte(img[:, :, :3]))
                img = _as_float(np.array(pil.filter(ImageFilter.GaussianBlur(s)))).astype(np.float32)
            out.append(img)
        return out


class RandomGrayscale:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, clip):
        out = []
        for img in clip:
            if random.random() < self.p:
                gray = img[..., :3] @ np.array([0.299, 0.587, 0.114], img.dtype)
                img = np.stack([gray] * 3, axis=-1)
            out.append(img)
        return out


class AllAugmentationTransform:
    """Composition (reference augmentation.py:384-418): flip -> rotation ->
    perspective -> resize -> crop -> jitter; blur/gray registered upstream but
    commented out — kept constructible here, off by default."""

    def __init__(self, resize_param=None, rotation_param=None, perspective_param=None,
                 flip_param=None, crop_param=None, jitter_param=None,
                 blur_param=None, gray_param=None):
        self.transforms: List = []
        if flip_param is not None:
            self.transforms.append(RandomFlip(**flip_param))
        if rotation_param is not None:
            self.transforms.append(RandomRotation(**rotation_param))
        if perspective_param is not None:
            self.transforms.append(RandomPerspective(**perspective_param))
        if resize_param is not None:
            self.transforms.append(RandomResize(**resize_param))
        if crop_param is not None:
            self.transforms.append(RandomCrop(**crop_param))
        if jitter_param is not None:
            self.transforms.append(ColorJitter(**jitter_param))

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip
