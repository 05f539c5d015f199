"""The yardstick of the pose LM kernel's roofline (`csrc/pose_lm.cu` of the
program): the work of one launch from the rows it takes.

A frozen count of the kernel's own arithmetic, a row at a time. Rows are
capacity rows, from the tensors' shapes as the program's counters give
them (`line_lm_rows`: point rows and two a line row; `line_lm_lines`: line
rows): every point row, and every line row with both of its views, though
the kernel skips the rows that are not valid or not inliers and a line row
without a right view has one view. So the work is an upper bound of what a
launch computes, and the share reads high, never low.

Bytes: each row's inputs read once and its inlier flag written once (a
point row 31: X, obs (uL, v, uR), information, stereo and valid flags,
inlier; a line row 63: X0, d, four endpoints, octave, right and valid
flags, inlier); a problem's pose in and out and its count add 132.
Float32 operations a pass (each add, multiply, divide, square root or power
one; compares and selects none): a point row 339 (its camera point 18, the
residual 11, chi2 6, the Huber cost and weight 7, the Jacobian 25, the 21
sums of H 210, of b 60, the cost and the count 2); a line row 1,015 (its
two points in the left camera, the right view's shift and the information
45, and 485 a view: the projections, the line, the residual and its 2 x 6
Jacobian 284, chi2 and the Huber cost and weight 11, H 147, b 42, the cost
1), and 73 more in a reclassification pass (both views' residuals and chi2
once more).
Passes: 1 + rounds x (iters + 1), of which `rounds` reclassify.
"""
from __future__ import annotations

POINT_ROW_BYTES = 31
LINE_ROW_BYTES = 63
PROBLEM_BYTES = 64 + 64 + 4
POINT_ROW_OPS = 339
LINE_ROW_OPS = 45 + 2 * 485
LINE_RECLASS_OPS = 73
# the line step's schedule: 2 rounds x 6 iterations
LINE_STEP_ROUNDS, LINE_STEP_ITERS = 2, 6


def launch(points: float, lines: float, rounds: int = LINE_STEP_ROUNDS,
           iters: int = LINE_STEP_ITERS, problems: int = 1
           ) -> tuple[float, float]:
    """(bytes, operations) of one launch of `points` point rows and `lines`
    line rows over `problems` problems."""
    passes = 1 + rounds * (iters + 1)
    return (points * POINT_ROW_BYTES + lines * LINE_ROW_BYTES
            + problems * PROBLEM_BYTES,
            passes * (points * POINT_ROW_OPS + lines * LINE_ROW_OPS)
            + rounds * lines * LINE_RECLASS_OPS)
