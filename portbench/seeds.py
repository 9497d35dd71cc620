"""Every draw of a run comes from --seed through these functions, so the
same seed gives the same weights, frames, tables and requests.  --seed may
be any whole number of up to 64 bits."""
from __future__ import annotations

import numpy as np

# what each stream is drawn for; a new purpose takes a new number
WEIGHTS, FRAMES, PAIRS, STEPS, SAMPLE = 0, 1, 2, 3, 5


def sub_seed(seed: int, purpose: int, index: int = 0) -> int:
    """A 63-bit seed for one purpose (and one index within it)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), purpose, index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose, index))


def step_seed(seed: int, step: int) -> int:
    """The seed of a training step's draws (augmentation, TPS): the step's
    generator is reseeded with it before the step, on both sides."""
    return sub_seed(seed, STEPS, step)
