"""Core arithmetic of the port: counter RNG, packing, the frugal and drift
ticks, lane programs, the sketch and chunked streaming ingest."""
