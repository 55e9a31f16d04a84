"""Comparison algorithms from the paper's §6 (plus extras).

These are the *non-frugal* streaming quantile algorithms the paper compares
against, implemented as sequential Python/numpy data structures (they are
pointer-chasing summaries — there is nothing to accelerate on a GPU, which is
precisely the paper's point: frugal sketches are the only variant whose state
vectorizes across millions of groups).

  gk.GKSummary          — Greenwald-Khanna with a hard tuple budget (t=20) and
                          the paper's ε-inflation compression (§6.1).
  qdigest.QDigest       — Shrivastava et al. q-digest with b buckets (§6.2).
  selection.Selection   — Guha-McGregor random-order selection (§6.3), the
                          unknown-n variant with exponentially growing phases.
  reservoir.Reservoir   — k-item reservoir sample (extra baseline).
  exact.ExactQuantile   — stores everything; ground truth.
  protocol              — QuantileEstimator, the shared
                          insert/extend/query/memory_words interface every
                          summary here answers (the frugal adapter is
                          repro_torch.api.FrugalEstimator), so benchmark
                          harnesses drive all of them through one loop.

The port's copy of the JAX package's ``core/baselines/``, statement for
statement: standard library only, and ``Selection`` / ``Reservoir`` seed
``random.Random`` alike, so one seed gives the same answers in both.
"""

from .gk import GKSummary
from .qdigest import QDigest
from .selection import Selection
from .reservoir import Reservoir
from .exact import ExactQuantile
from .protocol import QuantileEstimator

__all__ = ["GKSummary", "QDigest", "Selection", "Reservoir", "ExactQuantile",
           "QuantileEstimator"]
