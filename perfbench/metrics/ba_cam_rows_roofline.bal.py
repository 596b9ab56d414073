"""ba_cam_rows_roofline.bal: the least time of the traced solve's
ba_cam_rows calls on an H100 over the device time of its kernels, in %.
The least time counts each observation of the problem, not the padded
slots of its layout (lib/peaks.py); None where the kernels did not run."""

import sys

from perfbench.lib import peaks

KERNELS = peaks.CAM_ROWS_KERNELS


def read(run):
    t, u = run.trace, run.trace_unit
    calls = (u or {}).get("cam_calls", 0)
    if t is None or not calls:
        return None
    busy = t.kernel_seconds(KERNELS)
    if busy <= 0:
        return None
    s = u["shape"]
    least, by = peaks.least_seconds("cam", s["C"], s["P"], s["O"], s["D"])
    print(f"perfbench: ba_cam_rows least time {least:.3e} s a call, bound by "
          f"{by}; {calls} calls, {busy:.6f} s on the card", file=sys.stderr)
    return 100.0 * least * calls / busy
