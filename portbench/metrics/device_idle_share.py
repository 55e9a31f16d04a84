"""The share of the window in which no operation ran on the card: the
window's length less the union of the profiled device activity, over the
window's length."""


def read(run):
    if run.trace is None or run.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.window_s
