"""repro_torch.serve — the batched LLM serving engine (``engine.py``) and
its per-route serving SLO quantiles (``slo.py``), ports of the JAX
package's ``serve/``."""
from .engine import Request, ServeEngine
from .slo import DEFAULT_METRICS, SLOFleet

__all__ = ["ServeEngine", "Request", "SLOFleet", "DEFAULT_METRICS"]
