"""Frugal-1U (Ma, Muthukrishnan and Sandler 2014, Algorithm 2), the plain
reference of the lane program "1u", and its frozen operation counts.

One plane per lane, the estimate m: on item x it moves up by 1 when x > m
and the coin u > 1 - q, down by 1 when x < m and u > q. Every tensor is
of one floating dtype.
"""
import torch

PLANES = ("m",)
WORDS = 1

# Issue slots per lane-tick (see 2u.py): the lane round of the counter
# hash and the mantissa fill, then u against 1 - q and x against m for
# each branch and the two predicated moves of m. A copy of the counts the
# system published for its kernel on an H100 (sm_90).
LANE_TICK_OPS = {
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    "fp32 add": (3, 128),
    "compare": (4, 64),
}


def init(like, value):
    """The paper's start, shaped like ``like``: m = ``value``."""
    return (torch.zeros_like(like) + value,)


def tick(planes, x, u, q):
    """One tick of every lane: item ``x``, uniform ``u``, target ``q``."""
    (m,) = planes
    one, zero = torch.ones_like(m), torch.zeros_like(m)
    up = (x > m) & (u > 1 - q)
    down = (x < m) & (u > q)
    return (m + torch.where(up, one, zero) - torch.where(down, one, zero),)


def canonical(planes):
    """1U stores m as it is."""
    return planes


def query(planes):
    """The estimate of every lane."""
    return planes[0]
