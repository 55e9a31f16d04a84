"""Stream generators reproducing the paper's experimental data (§7).

The port's own copy of the JAX package's ``data/streams.py`` (numpy only):
the same generators, the same draws from the same numpy ``Generator``.

The real HTTP trace [5] and the Twitter crawl are not redistributable /
available offline, so the GROUPBY experiments use distribution-matched
synthetic proxies with the same stream counts, length filters, and metrics
as the paper (recorded in EXPERIMENTS.md per experiment):

  * §7.1 synthetic: Cauchy(x0=10000, gamma=1250), 3e4 samples; and the
    3-sub-stream dynamic variant over domains [10000,15000], [15000,20000],
    [20000,25000] (2e4 each) — generated EXACTLY as the paper specifies.
  * §7.2 TCP-flow proxy: per-site flow sizes ~ lognormal (heavy tail, bytes)
    and durations ~ lognormal with diurnal periodicity (the paper notes
    "periodic patterns are apparent" in durations — a series of large values
    followed by a series of small ones), 419 streams of >= 2000 items.
  * §7.3 Twitter proxy: per-user inter-tweet intervals ~ Pareto-ish mixture
    of bursts (seconds) and overnight gaps (tens of thousands of seconds),
    capped at 3200 tweets/user per the Twitter API limit the paper hits.

All generators take an explicit numpy Generator for reproducibility and
return positive values (domains per §2 are positive integers; paper footnote 1
scales non-integer domains — we keep floats, the algorithms only compare).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


# --------------------------------------------------------------- §7.1 Cauchy
def cauchy_stream(
    n: int = 30_000,
    x0: float = 10_000.0,
    gamma: float = 1_250.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Static Cauchy stream, paper §7.1 parameters (outlier-heavy on purpose)."""
    rng = rng or np.random.default_rng(0)
    return x0 + gamma * rng.standard_cauchy(n)


def dynamic_cauchy_stream(
    n_per: int = 20_000,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Three Cauchy sub-streams, domains clipped per the paper ([1e4,1.5e4],
    [1.5e4,2e4], [2e4,2.5e4]), ordered highest / lowest / middle median.

    Returns (stream, segment_ids) — segment ids mark distribution switches.
    """
    rng = rng or np.random.default_rng(0)
    doms = [(20_000.0, 25_000.0), (10_000.0, 15_000.0), (15_000.0, 20_000.0)]
    parts, segs = [], []
    for i, (lo, hi) in enumerate(doms):
        x0 = (lo + hi) / 2.0
        g = (hi - lo) / 8.0
        x = x0 + g * rng.standard_cauchy(n_per)
        x = np.clip(x, lo, hi)  # paper samples "in value domains [lo, hi]"
        parts.append(x)
        segs.append(np.full(n_per, i))
    return np.concatenate(parts), np.concatenate(segs)


# ------------------------------------------------------- §7.2 TCP-flow proxy
def tcp_like_group_streams(
    num_sites: int = 100,
    num_months: int = 6,
    min_len: int = 2_000,
    max_len: int = 12_000,
    kind: str = "size",
    rng: np.random.Generator | None = None,
) -> List[np.ndarray]:
    """Per-(site, month) flow-size or flow-duration streams.

    Paper filters streams shorter than 2000 items, keeping 419 of 600; we
    draw lengths so a similar fraction (~70%) survives, then apply the same
    filter. `kind='duration'` adds the paper's periodic large/small pattern.
    """
    rng = rng or np.random.default_rng(1)
    streams: List[np.ndarray] = []
    for site in range(num_sites):
        # per-site scale heterogeneity (sites differ wildly in flow size)
        mu = rng.uniform(5.5, 9.0)       # log-scale median e^mu ≈ 245B..8KB
        sigma = rng.uniform(0.8, 1.4)    # heavy tail, but TCP-size-like
        for month in range(num_months):
            n = int(rng.uniform(min_len * 0.35, max_len))
            x = rng.lognormal(mean=mu, sigma=sigma, size=n)
            if kind == "duration":
                # periodic pattern: alternating bursts of large / small values
                period = int(rng.uniform(200, 800))
                t = np.arange(n)
                phase = ((t // period) % 2).astype(np.float64)
                x = x * np.where(phase > 0, rng.uniform(4.0, 12.0), 1.0)
            streams.append(x)
    return [s for s in streams if len(s) >= min_len]


def combined_month_stream(
    n: int = 1_600_000,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Proxy for the 2004-03 combined duration stream (~1.6e6 items, µs):
    paper reports median ~544,267 µs and 90% ~1,464,793 µs; we match those
    quantiles with a lognormal fit (mu, sigma solved from the two quantiles).
    """
    rng = rng or np.random.default_rng(2)
    # lognormal: ln q50 = mu;  ln q90 = mu + 1.2816 sigma
    mu = np.log(544_267.0)
    sigma = (np.log(1_464_793.0) - mu) / 1.2816
    return rng.lognormal(mean=mu, sigma=sigma, size=n)


def dynamic_combined_stream(
    n: int = 1_600_000,
    rng: np.random.Generator | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Proxy for the 2003-12 stream whose contributing sites change mid-way
    (paper Fig. 9): distribution shifts at n/2."""
    rng = rng or np.random.default_rng(3)
    half = n // 2
    a = rng.lognormal(mean=np.log(300_000.0), sigma=0.9, size=half)
    b = rng.lognormal(mean=np.log(800_000.0), sigma=0.7, size=n - half)
    segs = np.concatenate([np.zeros(half), np.ones(n - half)])
    return np.concatenate([a, b]), segs


# ------------------------------------------------------- §7.3 Twitter proxy
def twitter_like_interval_streams(
    num_users: int = 4_554,
    cap: int = 3_200,
    min_len: int = 2_000,
    rng: np.random.Generator | None = None,
) -> List[np.ndarray]:
    """Per-user inter-tweet interval streams (seconds).

    Mixture: in-session gaps (lognormal, minutes) + overnight/idle gaps
    (lognormal, ~1e4-1e5 s). 90% of users' 90-percentile > 1e4 s, matching
    the paper's observation. Users are capped at 3200 tweets (API limit);
    streams shorter than 2000 are filtered like the paper (4414 remain).
    """
    rng = rng or np.random.default_rng(4)
    streams: List[np.ndarray] = []
    for u in range(num_users):
        n = int(rng.uniform(min_len * 0.45, cap))
        burst_p = rng.uniform(0.55, 0.9)
        mu_b = rng.uniform(3.0, 6.0)       # e^3..e^6 s  in-session
        mu_idle = rng.uniform(9.5, 11.5)   # e^9.5..e^11.5 s  idle gaps
        is_burst = rng.random(n) < burst_p
        x = np.where(
            is_burst,
            rng.lognormal(mu_b, 1.0, size=n),
            rng.lognormal(mu_idle, 0.6, size=n),
        )
        streams.append(x)
    return [s for s in streams if len(s) >= min_len]


def daily_combined_interval_streams(
    num_days: int = 905,
    min_len: int = 2_000,
    max_len: int = 20_000,
    rng: np.random.Generator | None = None,
) -> List[np.ndarray]:
    """Proxy for the 905 daily GROUPBY-combined interval streams (Fig. 11)."""
    rng = rng or np.random.default_rng(5)
    streams = []
    for d in range(num_days):
        n = int(rng.uniform(min_len, max_len))
        mu = rng.uniform(5.0, 8.0)
        x = rng.lognormal(mu, 1.4, size=n)
        streams.append(x)
    return streams


# --------------------------------------------------------------- worst case
def ascending_stream(n: int = 1_000) -> np.ndarray:
    """Paper Example 4.1 adversarial stream: strictly ascending order."""
    return np.arange(1.0, n + 1.0)


# ------------------------------------------------------------------ ragged
def pad_ragged(streams, dtype=np.float32) -> np.ndarray:
    """Stack ragged group streams into [T_max, G], padding with NaN.

    NaN compares False against anything, so a frugal update on a padded slot
    is a natural no-op (neither s > m̃ nor s < m̃ fires) — ragged GROUPBY
    ingestion costs nothing beyond the padding itself.
    """
    t_max = max(len(s) for s in streams)
    out = np.full((t_max, len(streams)), np.nan, dtype=dtype)
    for g, s in enumerate(streams):
        out[: len(s), g] = s
    return out
