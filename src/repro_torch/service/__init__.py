"""repro_torch.service — the composed streaming service on the card.

Port of the JAX package's ``service``: put-ahead host→device ingest
(``IngestPipeline``: pinned copies on a side CUDA stream while the dense
kernel applies the previous chunk) feeding one ``QuantileFleet``,
concurrent consistent reads (``Snapshot``, copy-on-query of the query
planes), per-tenant DP gating (``TenantPolicy`` through the ``2u-dp``
program), and live observability (``Telemetry``: monotonic counters +
frugal latency histograms). ``StreamingService`` wires them together;
every served answer, noised ones included, replays bit for bit.
"""
from .pipeline import IngestPipeline
from .server import INTERNAL, StreamingService, TenantPolicy
from .snapshot import Snapshot
from .telemetry import Telemetry, runtime_metadata

__all__ = [
    "IngestPipeline", "Snapshot", "StreamingService", "TenantPolicy",
    "INTERNAL", "Telemetry", "runtime_metadata",
]
