"""Host milliseconds a batch in the fleet API and streaming layer's own
code: the self time of ``fleet.ingest_stream`` (``api/fleet.py``) and of
``stream.next_block`` (``core/streaming.py``), from the spans of a traced
run's recorded window."""

NAMES = ("fleet.ingest_stream", "stream.next_block")


def read(run):
    return None if run.spans is None else run.spans.self_ms(NAMES)
