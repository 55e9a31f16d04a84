"""Host milliseconds a batch spends in the fleet's call, from the call to
its return and before the wait for the card (host clock), averaged over
the batches of the run's untraced window, which the profiler does not
slow: the host path of ``api/fleet.py`` and ``core/streaming.py`` down
to the launches."""


def read(run):
    if not run.call_s:
        return None
    return 1e3 * sum(run.call_s) / len(run.call_s)
