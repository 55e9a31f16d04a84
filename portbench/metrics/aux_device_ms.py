"""Device milliseconds a batch spends in operations that are not the frugal
kernels (packing and unpacking the state words, casts, the broadcast
targets of ``kernels/ops.py``), from the profiled window."""


def read(run):
    if run.trace is None or not run.batches:
        return None
    secs = sum(s for name, (_, s) in run.trace.ops.items()
               if not name.startswith("frugal_"))
    return 1e3 * secs / run.batches
