"""Kernel launches a batch, from the wrappers' counters
(``kernels/frugal_update.py``: ``launch_count`` of the dense kernel and
``scatter_launch_count`` of the event run kernel)."""


def read(run):
    if not run.batches:
        return None
    return sum(run.launches.values()) / run.batches
