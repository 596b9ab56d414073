"""The card's peaks and the least time of the port's two BA row kernels.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.

The row kernels' work is counted per observation of the problem, never per
padded slot of whatever layout implements them, so that the least time of
a solve stays the same when a change to the program pads or packs the
problem differently.  Each input is read once and each output written once;
the float operations a slot are those counted from csrc/ba_cam_rows.cu (D =
6 and 14) and csrc/ba_pt_rows.cu, a multiply-add counted as two.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores

CAM_ROWS_OPS = {6: 268, 14: 672}  # per observation
PT_ROWS_OPS = 210  # per observation

# kernel names in the device trace
CAM_ROWS_KERNELS = ("rows_kernel", "cams_kernel")
PT_ROWS_KERNELS = ("pt_rows_kernel",)


def _cam_side(C: int, P: int, O: int, D: int):
    """Bytes and operations of one ba_cam_rows call: camera parameters
    (q, t, 8 intrinsics: 60 B) and their five freeze flags (12 B), each
    point once (12 B), per observation its pixels, weight and point id
    (16 B) and its sqrt(w) Jc row pair out (8 D B), per camera U, bc out,
    and the cost."""
    nbytes = C * (60 + 12) + P * 12 + O * (16 + 8 * D) \
        + C * (D * D + D) * 4 + 4
    return nbytes, O * CAM_ROWS_OPS[D]


def _pt_side(C: int, P: int, O: int):
    """Bytes and operations of one ba_pt_rows call: camera parameters, each
    point and its freeze flag (13 B), per observation its pixels, weight
    and camera id (16 B) and Jp rows and weighted residual out (24 + 16 B),
    per point V and bp out (48 B)."""
    nbytes = C * 60 + P * (13 + 48) + O * (16 + 24 + 16)
    return nbytes, O * PT_ROWS_OPS


def least_seconds(kind: str, C: int, P: int, O: int, D: int = 6):
    """(seconds, "bytes" or "operations"): the least time of one call of
    the camera-side ("cam") or point-side ("pt") kernel on this problem,
    and which of the two bounds it."""
    nbytes, ops = _cam_side(C, P, O, D) if kind == "cam" else _pt_side(C, P, O)
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S
    return max(tb, to), ("bytes" if tb >= to else "operations")
