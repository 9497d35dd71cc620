"""The metric arithmetic: the idle union, the roofline and MFU formulas,
the p95 with failures counted as missing, and the check numbers."""
from __future__ import annotations

import math

import pytest

from portbench import checks, readers, roofline, trace
from portbench.drivers.serve import p95_with_failures


@pytest.mark.parametrize("intervals,lo,hi,want", [
    ([(0, 2), (1, 3), (5, 6)], None, None, 4),
    ([(0, 10), (2, 3), (4, 5)], None, None, 10),
    ([(0, 2), (1, 3), (5, 6)], 1.5, 5.5, 2.0),
    ([(3, 4), (0, 1)], None, None, 2),
    ([], None, None, 0),
])
def test_union_length_with_overlaps(intervals, lo, hi, want):
    assert trace.union_length(intervals, lo, hi) == pytest.approx(want)


def test_merged():
    assert trace.merged([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]


def test_conv_forward_work():
    # x [2,3,8,8], w [4,3,3,3], stride 1, padding 1: out [2,4,8,8]
    flops, nbytes = roofline.conv_work(
        "aten::convolution", [[2, 3, 8, 8], [4, 3, 3, 3], [4]],
        [None, None, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1], 4)
    assert flops == 2 * 2 * 4 * 64 * 3 * 9
    assert nbytes == 4 * (2 * 3 * 64 + 4 * 27 + 4 + 2 * 4 * 64)


def test_conv_backward_work_counts_each_gradient():
    shapes = [[2, 4, 8, 8], [2, 3, 8, 8], [4, 3, 3, 3]]
    concrete = [None, None, None, [4], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, True, False]]
    flops, _ = roofline.conv_work("aten::convolution_backward", shapes, concrete, 4)
    assert flops == 2 * 2 * (2 * 4 * 64 * 3 * 9)
    concrete[-1] = [False, True, False]
    assert roofline.conv_work("aten::convolution_backward", shapes, concrete, 4)[0] == \
        2 * 2 * 4 * 64 * 3 * 9


def test_conv_share_is_least_time_over_device_time():
    op = ("aten::convolution", [[8, 64, 64, 64], [64, 64, 3, 3], [64]],
          [None, None, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1], 0.0)
    flops, nbytes = roofline.conv_work(op[0], op[1], op[2], 4)
    least = max(flops / 67e12, nbytes / 3.35e12)
    share = roofline.conv_share([op[:3] + (2 * least,)], 4, 67e12, 3.35e12)
    assert share == pytest.approx(0.5)


def test_warp_work_is_bound_ms_arithmetic():
    N, D, H, W, C, K1, item = 8, 16, 64, 64, 4, 15, 4
    NV = D * H * W
    f, b = roofline.warp_work("fwd", N, D, H, W, C, K1, item)
    assert f == N * K1 * NV * 8 * (2 * C + 12)
    assert b == N * NV * C * item + 3 * N * K1 * NV * 4 + N * NV * K1 * C * item
    assert roofline.warp_work("bwd_dx", N, D, H, W, C, K1, item)[1] == \
        3 * N * K1 * NV * 4 + N * NV * K1 * C * item + N * NV * C * 4


class _Ctx:
    kind, conv_peak, slice = "train", "float32", None

    def __init__(self, facts):
        self.facts = facts


def test_mfu_formula():
    ctx = _Ctx({"flops_per_unit": 15.6e12, "window_units": 20, "window_s": 30.0})
    assert readers.mfu(ctx, "train") == pytest.approx(100 * 15.6e12 * 20 / 30.0 / 67e12)
    assert readers.mfu(ctx, "serve") is None
    assert readers.mfu(_Ctx({"flops_per_unit": None, "window_units": 1, "window_s": 1}),
                       "train") is None


def test_p95_counts_failures_as_missing():
    lat = [0.1] * 95 + [0.2] * 5
    assert p95_with_failures(lat, 0) == 0.1
    assert p95_with_failures(lat[:90], 10) == math.inf
    assert p95_with_failures([0.1] * 94 + [0.2], 5) == 0.2
    assert p95_with_failures([], 0) is None


def test_norm_gap_worst_leaf_against_median():
    ref = [1.0, 2.0, 3.0, 1e-9]
    assert checks.norm_gap(ref, ref) == 0.0
    # a leaf left unmoved reads 1, one moved double reads 1
    assert checks.norm_gap([0.0, 2.0, 3.0, 1e-9], ref) == pytest.approx(0.5)
    assert checks.norm_gap([1.0, 4.0, 3.0, 1e-9], ref) == pytest.approx(1.0)
    # a near-zero leaf is measured against the median leaf, not itself
    assert checks.norm_gap([1.0, 2.0, 3.0, 2e-9], ref) == pytest.approx(1e-9 / 2.0)
    assert checks.norm_gap([1.0, float("nan"), 3.0, 0.0], ref) == math.inf


def test_change_gap_leaves_out_small_gradients():
    nums = checks.train_numbers(
        {"losses": [[1.0, 2.0]], "grad": [1.0, 1.0, 1e-6], "change": [1.0, 1.0, 9.0],
         "buffers": [1.0]},
        {"losses": [[1.0, 2.0]], "grad": [1.0, 1.0, 1e-6], "change": [1.0, 1.0, 1.0],
         "buffers": [1.0]})
    assert nums["change_gap_median"] == 0.0 and nums["first_loss_gap"] == 0.0


def test_median_gap_reads_one_for_a_state_left_unchanged():
    ref = [1.0, 2.0, 3.0, 4.0, 5.0]
    assert checks.median_gap([0.0] * 5, ref) == 1.0
    assert checks.median_gap([2 * r for r in ref], ref) == 1.0
    assert checks.median_gap([1.0, 2.0, 3.0, 40.0, 5.0], ref) == 0.0


def test_first_loss_gap_reads_the_first_step_only():
    nums = checks.train_numbers(
        {"losses": [[1.0, 2.0], [9.0, 9.0]], "grad": [1.0], "change": [1.0], "buffers": [1.0]},
        {"losses": [[1.0, 2.2], [1.0, 1.0]], "grad": [1.0], "change": [1.0], "buffers": [1.0]})
    assert nums["first_loss_gap"] == pytest.approx(0.2 / 2.2)


def test_verdict():
    assert checks.verdict({"a": 1.0}, {"a": 2.0})
    assert not checks.verdict({"a": 3.0}, {"a": 2.0})
    assert not checks.verdict({}, {"a": 2.0})


def test_byte_mismatch_takes_any_rounding_within_the_slack():
    import numpy as np
    from portbench import serve_reference as sr
    ref = {(0, 0): np.full((2, 2, 3), 100 / 255, np.float32)}     # on a boundary
    below = np.full((2, 2, 3), 99, np.uint8)                       # a float a hair under
    assert sr.numbers([], [((0, 0), below)], ref)["byte_mismatch"] == 0.0
    off = below.copy()
    off[0, 0, 0] = 97
    assert sr.numbers([], [((0, 0), off)], ref)["byte_mismatch"] == 1 / 12
    assert sr.numbers([((0, 0), ref[(0, 0)] + 1e-3)], [], ref)["frame_gap"] == \
        pytest.approx(1e-3, rel=1e-4)
