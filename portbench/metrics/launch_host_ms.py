"""Host milliseconds a dense launch takes in its wrapper
(``kernels.dense_launch`` of ``kernels/frugal_update.py``: the checks,
the outputs and the ctypes launch), from the spans of a traced run's
recorded window."""


def read(run):
    if run.spans is None:
        return None
    return run.spans.entry_ms("kernels.dense_launch")
