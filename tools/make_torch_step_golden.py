#!/usr/bin/env python
"""Record the port's bf16 training step on the CPU for chip_smoke.py:
tests/data/torch_bf16_step_tiny.npz.

chip_smoke.py's train_tiny phase holds the card's tiny_config() bf16 step to
the port's CPU bf16 step.  Run on the card's machine, two such CPU steps
did not finish in 20 minutes, so the step is recorded on a CPU that runs it
in seconds, from inputs that every machine reproduces: the weights from
chip_smoke.numpy_weights (numpy's RandomState), the images and TPS
parameters from chip_smoke.tiny_step_inputs.  It saves

  loss/<name>, grad/<net>/<param>        the CPU bf16 step's losses and
                                         G and D gradients
  noise/loss/<name>, noise/grad/<net>/<param>
      the step's own bf16 rounding noise on each: the largest max-distance
      from the bf16 answer of the CPU fp32 step's answer and of NUDGES bf16
      steps on images nudged by half a bf16 ulp (chip_smoke.BF16_NUDGE).
      In training mode that noise is heavy-tailed (measured on one
      gradient leaf over five nudges: 7.6 to 70.2), so one nudge
      underestimates it.

tests/test_torch_bf16.py::test_bf16_step_golden_is_reproduced recomputes it.

Usage:  python tools/make_torch_step_golden.py [--out PATH]
"""
from __future__ import annotations

import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

NUDGES = 4


def record():
    """The arrays of the golden (see the module docstring)."""
    rs, batch, tp = chip_smoke.tiny_step_inputs()
    ref = chip_smoke.tiny_step("cpu", batch, "bfloat16", tp)
    others = [chip_smoke.tiny_step("cpu", batch, "float32", tp)]
    for _ in range(NUDGES):
        nudged = [(b * (1 + chip_smoke.BF16_NUDGE * rs.randn(*b.shape))).astype(np.float32)
                  for b in batch]
        others.append(chip_smoke.tiny_step("cpu", nudged, "bfloat16", tp))
    arrays = {}
    for k, v in ref[0].items():
        arrays[f"loss/{k}"] = np.float32(v)
        arrays[f"noise/loss/{k}"] = np.float32(max(abs(o[0][k] - v) for o in others))
    for n, grads in ref[1].items():
        for k, g in grads.items():
            arrays[f"grad/{n}/{k}"] = g
            arrays[f"noise/grad/{n}/{k}"] = np.float32(
                max(chip_smoke._distance(o[1][n][k], g) for o in others))
    return arrays


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(chip_smoke.BF16_STEP_GOLDEN))
    args = p.parse_args(argv)
    arrays = record()
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, {len(arrays)} arrays); losses "
          + ", ".join(f"{k[5:]} {float(v):.5f}" for k, v in arrays.items() if k.startswith("loss/")))


if __name__ == "__main__":
    main()
