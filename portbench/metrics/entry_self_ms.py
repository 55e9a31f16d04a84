"""Host milliseconds a batch in the entry points' own code
(``kernels/ops.py``): the self time of ``ops.update_auto``, ``ops.blocks``,
``ops.pack`` and ``ops.unpack``, from the spans of a traced run's
recorded window."""

NAMES = ("ops.update_auto", "ops.blocks", "ops.pack", "ops.unpack")


def read(run):
    return None if run.spans is None else run.spans.self_ms(NAMES)
