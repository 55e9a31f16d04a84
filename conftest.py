"""Root pytest hooks, loaded in every pytest-xdist worker.

Each worker runs its own torch intra-op thread pool, sized by default to
every CPU the process may use; n workers would then run n times that many
threads and slow each other down. Under xdist, each worker takes an equal
share of the CPUs. A run without xdist is left as it is.
"""
import os


def pytest_configure(config):
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    import torch

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
