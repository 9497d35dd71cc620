"""Seeded frames made on the device, and the (source, driving) tables that
feed the training cells.

``smooth_clips`` is data/synthetic.py:smooth_frames of the program, in
torch on the device: per clip two frequencies and a phase per channel drawn
from the seed, a pattern that moves with time, and a seeded grain of
+-``grain`` levels (the grain a camera's frames carry).  Training cells
hold identities x clips x frames of them as one uint8 tensor on the card,
as the program's frame cache does.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import seeds


def smooth_clips(clips: int, frames: int, size: int, seed: int, grain: int,
                 device) -> torch.Tensor:
    """uint8 [clips * frames, size, size, 3], clip after clip."""
    g = torch.Generator(device=device).manual_seed(seeds.sub_seed(seed, seeds.FRAMES))
    f = 2 + 4 * torch.rand(clips, 2, 3, generator=g, device=device)
    p = 6 * torch.rand(clips, 3, generator=g, device=device)
    axis = torch.arange(size, device=device, dtype=torch.float32) / size
    y, x = axis[:, None, None], axis[None, :, None]                  # [S,1,1], [1,S,1]
    t = torch.arange(frames, device=device, dtype=torch.float32)
    out = torch.empty(clips, frames, size, size, 3, dtype=torch.uint8, device=device)
    for c in range(clips):
        sx = torch.sin(f[c, 0] * x + p[c] + 0.3 * t[:, None, None, None])   # [T,1,S,3]
        cy = torch.cos(f[c, 1] * y + p[c])                                  # [S,1,3]
        img = 255 * (0.5 + 0.4 * sx * cy)
        if grain:
            img = img + torch.randint(-grain, grain + 1, img.shape, generator=g,
                                      device=device)
        out[c] = img.clamp_(0, 255).to(torch.uint8)
    return out.reshape(clips * frames, size, size, 3)


def pair_tables(seed: int, steps: int, batch: int, identities: int, clips: int,
                frames: int, distinct_steps: int):
    """[steps, batch] source and driving frame indices: each row an identity,
    one of its clips and two frames of that clip with replacement, sorted
    (the program's FramesDataset sampling).  The rows of the first
    ``distinct_steps`` steps are all different pairs."""
    r = seeds.rng(seed, seeds.PAIRS)
    ident = r.integers(0, identities, (steps, batch))
    clip = ident * clips + r.integers(0, clips, (steps, batch))
    two = np.sort(r.integers(0, frames, (steps, batch, 2)), axis=-1)
    seen = set()
    for k in range(distinct_steps):
        for b in range(batch):
            while (int(clip[k, b]), *map(int, two[k, b])) in seen:
                two[k, b] = np.sort(r.integers(0, frames, 2))
            seen.add((int(clip[k, b]), *map(int, two[k, b])))
    return clip * frames + two[..., 0], clip * frames + two[..., 1]
