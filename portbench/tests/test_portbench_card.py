"""The controls, on a card at the cells' own sizes: the reference in the
program's place at the precision below the configuration's must fail the
cell's limits.  Run on the chip:

    python3 -m pytest portbench/tests/test_portbench_card.py -m cuda
"""
from __future__ import annotations

import pytest
import torch

from portbench import checks, run as runmod
from portbench import serve_reference as sr
from portbench import train_reference as tr

SEED = 2 ** 31 + 99


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    runmod.set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_control_fails_the_limits():
    device = _card()
    cell, config = runmod.cell_files("train-fp32")
    ref = tr.run(config, cell["traffic"], SEED, device)
    control = tr.run(config, cell["traffic"], SEED, device, precision=config["lower_precision"])
    numbers = checks.train_numbers(control, ref)
    assert not checks.verdict(numbers, cell["limits"]), numbers


@pytest.mark.cuda
def test_serve_control_fails_the_limits():
    device = _card()
    cell, config = runmod.cell_files("serve-fp32-c16")
    t = cell["traffic"]
    from portbench import frames
    size = 256
    clip = frames.smooth_clips(t["sessions"], t["frames_per_session"] + 1, size, SEED, t["grain"],
                               device).reshape(t["sessions"], -1, size, size, 3).cpu().numpy()
    sources, driving = clip[:, 0], clip[:, 1:]
    pairs = [(s, f) for s in range(t["sessions"]) for f in range(8)]
    ref, _ = sr.frames_for(config, SEED, device, sources, driving, pairs)
    low, _ = sr.frames_for(config, SEED, device, sources, driving, pairs,
                           precision=config["lower_precision"])
    rows = [(k, low[k]) for k in pairs]
    answers = [(k, sr.as_bytes(low[k])) for k in pairs]
    numbers = sr.numbers(rows, answers, ref)
    assert not checks.verdict(numbers, cell["limits"]), numbers
