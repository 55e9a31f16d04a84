"""Host milliseconds a batch from the start of the fleet's call
(``fleet.ingest_stream``) to the end of its first kernel launch
(``kernels.dense_launch``): the program's host path in front of the card,
from the spans of a traced run's recorded window."""


def read(run):
    if run.spans is None:
        return None
    return run.spans.lead_ms("fleet.ingest_stream", "kernels.dense_launch")
