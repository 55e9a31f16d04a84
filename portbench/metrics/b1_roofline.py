"""The dense kernel's share of its roofline, in percent: the least time an
H100 needs for a call of the cell's shape and program (``roofline.py``,
published peaks, the frozen counts) over the profiled device time of a
``frugal_dense_kernel`` launch in the window."""
from portbench import roofline


def read(run):
    shape = run.work.get("dense_call")
    if run.trace is None or shape is None:
        return None
    calls, secs = run.trace.kernel("frugal_dense_kernel")
    if not calls or secs <= 0:
        return None
    return 100.0 * roofline.dense_call_s(run.program, *shape) * calls / secs
