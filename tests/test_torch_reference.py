"""The port's scalar transcriptions of the paper's Algorithms 1-3 and its
§7 metric (``repro_torch.core.reference``) against the JAX package's: the
same Python floats on the same numpy-seeded streams and uniforms, and the
paper's worked examples (Figures 1-3) run in the port."""
import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro_torch.core import frugal as tfrugal
from repro_torch.core import reference as tref


def stream_case(seed, n=3000):
    rng = np.random.default_rng(seed)
    stream = np.round(rng.lognormal(4.0, 1.2, n), 2).tolist()
    rands = rng.random(n).tolist()
    return stream, rands


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frugal1u_median_scalar_matches_jax(seed):
    stream, _ = stream_case(seed)
    for m0 in (0.0, 37.5):
        assert tref.frugal1u_median_scalar(stream, m0) == \
            jref.frugal1u_median_scalar(stream, m0)


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 0.99])
@pytest.mark.parametrize("seed", [0, 1])
def test_frugal_scalars_match_jax(seed, q):
    stream, rands = stream_case(seed)
    for fn in ("frugal1u_scalar", "frugal2u_scalar"):
        jt, tt = [], []
        want = getattr(jref, fn)(stream, rands, quantile=q, trace=jt)
        got = getattr(tref, fn)(stream, rands, quantile=q, trace=tt)
        assert got == want and tt == jt, fn
    jt, tt = [], []
    want = jref.frugal2u_scalar(stream, rands, q, m=10.0, step=-3.0,
                                sign=-1.0, trace=jt)
    got = tref.frugal2u_scalar(stream, rands, q, m=10.0, step=-3.0,
                               sign=-1.0, trace=tt)
    assert got == want and tt == jt


@pytest.mark.parametrize("q", [0.05, 0.5, 0.9])
def test_relative_mass_error_matches_jax(q):
    stream, _ = stream_case(4, n=2001)
    ss = sorted(stream)
    for est in (ss[0] - 1.0, ss[0], ss[1000], ss[-1], ss[-1] + 5.0, 55.55):
        assert tref.relative_mass_error(est, ss, q) == \
            jref.relative_mass_error(est, ss, q)
    assert tref.relative_mass_error(1.0, [], q) == 0.0


def _alg1_trace(stream):
    trace, m = [], 0.0
    for s in stream:
        m = tref.frugal1u_median_scalar([s], m)
        trace.append(m)
    return trace


@pytest.mark.parametrize("stream, want", [
    ([4, 2, 1, 5, 3, 2, 5, 4], [1, 2, 1, 2, 3, 2, 3, 4]),      # Figure 1
    ([1, 10, 10, 1, 10, 1, 10, 1], [1, 2, 3, 2, 3, 2, 3, 2]),  # Figure 2
    (list(range(1, 9)), [1, 2, 3, 4, 5, 6, 7, 8]),             # Figure 3
], ids=["figure1", "figure2", "figure3"])
def test_paper_figures(stream, want):
    assert _alg1_trace(stream) == want
    # Algorithm 2 at q = 1/2 with every uniform above 1/2 is Algorithm 1.
    trace = []
    tref.frugal1u_scalar(stream, [0.9] * len(stream), quantile=0.5,
                         trace=trace)
    assert trace == want


def test_vectorized_port_matches_figure1():
    stream = torch.tensor([4, 2, 1, 5, 3, 2, 5, 4], dtype=torch.float32)
    items = stream[:, None].repeat(1, 4)
    st = tfrugal.frugal1u_init(4, device="cpu")
    st, trace = tfrugal.frugal1u_process(st, items,
                                         rand=torch.full_like(items, 0.9),
                                         return_trace=True)
    assert st.m.tolist() == [4.0] * 4
    assert trace[:, 0].tolist() == [1, 2, 1, 2, 3, 2, 3, 4]


def test_rank_quantile_semantics_out_of_domain_ok():
    # Figure 2: 3 is outside the {1, 10} domain but rank-correct.
    stream = sorted([1, 10, 10, 1, 10, 1, 10, 1])
    assert abs(tref.relative_mass_error(3.0, stream, 0.5)) <= 0.25
