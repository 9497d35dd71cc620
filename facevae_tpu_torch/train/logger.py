"""Training logger (a copy of facevae_tpu/train/logger.py, not an import of
it): the add.txt log and the epoch visualization.

Text log format is byte-compatible with add.txt ("G%08d) P - x; ...",
"D%08d) G1 - ...") including the quirk-q4 special case: the K column is
averaged over nonzero entries only (nan when K never fires).  The
visualization is written as a PNG by the port's writer (data/image_io.py).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from facevae_tpu_torch.data.image_io import write_png
from facevae_tpu_torch.parallel.mesh import is_master


class ScalarLog:
    """Accumulates per-iteration loss dicts; writes epoch means in add.txt format."""

    def __init__(self, log_path: str, zfill_num: int = 8):
        self.g_losses: List[List[float]] = []
        self.d_losses: List[List[float]] = []
        self.g_names: Optional[List[str]] = None
        self.d_names: Optional[List[str]] = None
        self.zfill_num = zfill_num
        if is_master():
            parent = os.path.dirname(log_path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self.log_file = open(log_path, "a")
        else:
            self.log_file = None

    # Reference column order (trainer.py:240-252 weights-dict order, the
    # order add.txt lines carry).  Metrics dicts arrive ALPHABETIZED by the
    # jit pytree round-trip, so the order must be reimposed here — it also
    # anchors quirk q4 ("column -2" = K) to the right column.
    _G_ORDER = ("P", "G", "F", "E", "L", "H", "D", "C", "K", "R")
    _D_ORDER = ("G1", "G2")

    def log_iter(self, losses_g: Dict[str, float], losses_d: Dict[str, float]) -> None:
        if self.g_names is None:
            self.g_names = ([k for k in self._G_ORDER if k in losses_g]
                            + [k for k in losses_g if k not in self._G_ORDER])
            self.d_names = ([k for k in self._D_ORDER if k in losses_d]
                            + [k for k in losses_d if k not in self._D_ORDER])
        self.g_losses.append([float(losses_g[k]) for k in self.g_names])
        self.d_losses.append([float(losses_d[k]) for k in self.d_names])

    def log_epoch(self, epoch: int) -> None:
        if self.log_file is None or not self.g_losses:
            self.g_losses, self.d_losses = [], []
            return
        g = np.asarray(self.g_losses)
        mean = g.mean(axis=0)
        # quirk q4 (logger.py:75): column -2 (K) averages only nonzero entries
        if g.shape[1] >= 2:
            col = g[:, -2]
            nz = (col != 0).sum()
            with np.errstate(invalid="ignore", divide="ignore"):
                mean[-2] = col.sum() / nz if nz else float("nan")
        line = "; ".join(f"{n} - {v:.5f}" for n, v in zip(self.g_names, mean))
        print(f"G{str(epoch).zfill(self.zfill_num)}) {line}", file=self.log_file)
        d = np.asarray(self.d_losses).mean(axis=0)
        line = "; ".join(f"{n} - {v:.5f}" for n, v in zip(self.d_names, d))
        print(f"D{str(epoch).zfill(self.zfill_num)}) {line}", file=self.log_file)
        self.log_file.flush()
        self.g_losses, self.d_losses = [], []

    def close(self):
        if self.log_file is not None:
            self.log_file.close()


# matplotlib's gist_rainbow (matplotlib/_cm.py _gist_rainbow_data): (x, RGB)
# points that LinearSegmentedColormap.from_list interpolates into a table
_GIST_RAINBOW = ((0.000, (1.00, 0.00, 0.16)), (0.030, (1.00, 0.00, 0.00)),
                 (0.215, (1.00, 1.00, 0.00)), (0.400, (0.00, 1.00, 0.00)),
                 (0.586, (0.00, 1.00, 1.00)), (0.770, (0.00, 0.00, 1.00)),
                 (0.954, (1.00, 0.00, 1.00)), (1.000, (1.00, 0.00, 0.75)))
_LUT_SIZE = 256


def _lookup_table(n: int = _LUT_SIZE) -> np.ndarray:
    """[n, 4] float64 RGBA, as matplotlib.colors._create_lookup_table builds
    each channel's table from the points (alpha 1)."""
    x = np.array([p[0] for p in _GIST_RAINBOW]) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.ones((n, 4))
    for c in range(3):
        y = np.array([p[1][c] for p in _GIST_RAINBOW])
        lut[:, c] = np.clip(np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1])
                                            + y[ind - 1], [y[-1]]]), 0.0, 1.0)
    return lut


_LUT = _lookup_table()


def gist_rainbow(value: float) -> tuple:
    """matplotlib.pyplot.get_cmap("gist_rainbow")(value) for value in
    [0, 1]: the RGBA tuple of table entry int(value * 256), 256 -> 255."""
    i = value * _LUT_SIZE
    i = _LUT_SIZE - 1 if i == _LUT_SIZE else i
    return tuple(_LUT[int(np.clip(i, 0, _LUT_SIZE - 1))])


class Visualizer:
    """Image-grid visualizer (reference logger.py:187-284): source/warped/
    driving columns with keypoint dots, prediction, occlusion map, K+1 mask
    channels colored by matplotlib's gist_rainbow (gist_rainbow below: the
    card's machine has no matplotlib)."""

    def __init__(self, kp_size: int = 5, draw_border: bool = True,
                 colormap: str = "gist_rainbow"):
        if colormap != "gist_rainbow":
            raise ValueError(f"the port's Visualizer has gist_rainbow only, not {colormap!r}")
        self.kp_size = kp_size
        self.draw_border = draw_border
        self.colormap = gist_rainbow

    def _draw_kp(self, image: np.ndarray, kp: np.ndarray) -> np.ndarray:
        image = np.array(image, copy=True)
        h, w = image.shape[:2]
        spatial = np.array([[w, h]], np.float32)
        kp = spatial * (kp + 1) / 2
        # same disc test as the reference grid version, evaluated only inside
        # each dot's bounding box (the full-image mask per keypoint was the
        # visualizer's host-time hog: 360 × H*W boolean grids per epoch grid)
        r = self.kp_size
        for i, (cx, cy) in enumerate(kp):
            y0, y1 = max(int(np.floor(cy)) - r, 0), min(int(np.ceil(cy)) + r + 1, h)
            x0, x1 = max(int(np.floor(cx)) - r, 0), min(int(np.ceil(cx)) + r + 1, w)
            if y0 >= y1 or x0 >= x1:
                continue
            yy, xx = np.mgrid[y0:y1, x0:x1]
            mask = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r ** 2
            image[y0:y1, x0:x1][mask] = np.asarray(self.colormap(i / len(kp)))[:3]
        return image

    def _column(self, images: np.ndarray) -> np.ndarray:
        if self.draw_border:
            images = np.array(images, copy=True)
            images[:, :, [0, -1]] = 1.0
        return np.concatenate(list(images), axis=0)

    def visualize(self, s, d, generated_d, transformed_d, kp_s, kp_d,
                  transformed_kp, occlusion, mask) -> np.ndarray:
        """All inputs channel-last numpy: images [N,H,W,3], occlusion [N,h,w,1],
        mask [N,D,h,w,K+1] or pre-summed over depth [N,h,w,K+1] (the train
        aux carries the depth-summed form — the display only ever shows the
        depth sum, and the full volume is 16x the device->host traffic)."""
        cols = []
        cols.append(self._column(np.stack([self._draw_kp(im, k[:, :2])
                                           for im, k in zip(s, kp_s)])))
        cols.append(self._column(np.stack([self._draw_kp(im, k[:, :2])
                                           for im, k in zip(transformed_d, transformed_kp)])))
        cols.append(self._column(np.stack([self._draw_kp(im, k[:, :2])
                                           for im, k in zip(d, kp_d)])))
        cols.append(self._column(generated_d))

        H, W = s.shape[1:3]
        occ = np.repeat(occlusion, 3, axis=-1)
        occ = _nearest_resize(occ, (H, W))
        cols.append(self._column(occ))

        if mask is not None:
            K1 = mask.shape[-1]
            for i in range(K1):
                m = (mask[..., i].sum(axis=1) if mask.ndim == 5
                     else mask[..., i])                             # sum over depth
                m = np.repeat(m[..., None], 3, axis=-1)
                m = _nearest_resize(m, (H, W))
                if i != 0:
                    color = np.asarray(self.colormap((i - 1) / (K1 - 1)))[:3]
                    m = m * color.reshape(1, 1, 1, 3)
                cols.append(self._column(m))

        image = np.concatenate(cols, axis=1)
        return (255 * image.clip(0, 1)).astype(np.uint8)


def _nearest_resize(x: np.ndarray, out_hw) -> np.ndarray:
    N, h, w = x.shape[:3]
    Ho, Wo = out_hw
    iy = np.floor(np.arange(Ho) * (h / Ho)).astype(np.int64)
    ix = np.floor(np.arange(Wo) * (w / Wo)).astype(np.int64)
    return x[:, iy][:, :, ix]


def save_visualization(vis_dir: str, epoch: int, image: np.ndarray,
                       zfill_num: int = 8) -> Optional[str]:
    if not is_master():
        return None
    os.makedirs(vis_dir, exist_ok=True)
    path = os.path.join(vis_dir, f"{str(epoch).zfill(zfill_num)}-rec.png")
    write_png(path, image)
    return path
