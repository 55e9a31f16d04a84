"""repro_torch.serve — per-route serving SLO quantiles (the port of the JAX
package's ``serve/slo.py``; the LLM engine of ``serve/engine.py`` belongs
to the training scaffold and is not ported yet)."""
from .slo import DEFAULT_METRICS, SLOFleet

__all__ = ["SLOFleet", "DEFAULT_METRICS"]
