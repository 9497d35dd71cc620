"""Synthetic frame datasets: seeded smooth moving patterns written as PNG
frame directories in the layout FramesDataset splits (test/ and train/).
chip_smoke.py's eval phase and the evaluation tests read them.
"""
from __future__ import annotations

import os
from typing import Callable, List

import numpy as np

from facevae_tpu_torch.data.image_io import write_png


def smooth_frames(n: int, size: int, seed: int, noise: int = 0) -> List[np.ndarray]:
    """n uint8 RGB frames [size,size,3] of a seeded moving pattern; with
    noise > 0, each pixel moved by a seeded integer in [-noise, noise] (the
    grain of a camera's frames, which a PNG encoder's row filters meet)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[:size, :size] / size
    f, p = rs.uniform(2, 6, (2, 3)), rs.uniform(0, 6, 3)
    frames = [255 * (0.5 + 0.4 * np.stack([np.sin(f[0, c] * x + 0.3 * t + p[c])
                                           * np.cos(f[1, c] * y + p[c]) for c in range(3)], -1))
              for t in range(n)]
    if noise:
        frames = [np.clip(fr + rs.randint(-noise, noise + 1, fr.shape), 0, 255)
                  for fr in frames]
    return [fr.astype(np.uint8) for fr in frames]


def write_dataset(root: str, size: int, videos: int, frames: int,
                  write: Callable[[str, np.ndarray], None] = write_png,
                  noise: int = 0) -> str:
    """test/ with ``videos`` videos of ``frames`` PNG frames, train/ with one
    video of two, each frame written by ``write(path, frame)`` (the port's
    write_png by default); returns root."""
    for split, names, n in (("test", [f"id{i}#clip0" for i in range(videos)], frames),
                            ("train", ["id9#clip0"], 2)):
        for j, name in enumerate(names):
            os.makedirs(os.path.join(root, split, name))
            seed = 10 * j + (split == "train")
            for t, img in enumerate(smooth_frames(n, size, seed, noise)):
                write(os.path.join(root, split, name, f"{t:07d}.png"), img)
    return root


def write_training_tree(root: str, size: int, ids: int, clips: int, frames: int,
                        write: Callable[[str, np.ndarray], None] = write_png,
                        noise: int = 0) -> str:
    """train/ with ``ids`` identities of ``clips`` clips (``id<i>#clip<c>``)
    of ``frames`` PNG frames each, test/ with one video of ``frames``, each
    frame written by ``write(path, frame)``; returns root."""
    names = [("train", f"id{i}#clip{c}") for i in range(ids) for c in range(clips)]
    for j, (split, name) in enumerate(names + [("test", "id0#clip0")]):
        os.makedirs(os.path.join(root, split, name))
        for t, img in enumerate(smooth_frames(frames, size, 100 + j, noise)):
            write(os.path.join(root, split, name, f"{t:07d}.png"), img)
    return root
