"""Frugal-2U (Ma, Muthukrishnan and Sandler 2014, Algorithm 3), the plain
reference of the lane program "2u", and its frozen operation counts.

Planes per lane: the estimate m, the adaptive step and the sign (+1 or -1)
of the last move, with the paper's constant step function f(step) = 1.
The tick is the paper's pseudocode as branch-free selects, evaluated in
the order the system documents (line numbers are Algorithm 3's). Every
tensor is of one floating dtype.
"""
import torch

PLANES = ("m", "step", "sign")
# Persistent 32-bit words per lane between dense calls: m as is, and
# (step, sign) packed into one word (see ``canonical``).
WORDS = 2

# Issue slots per lane-tick of one Frugal-2U tick with its lane's round of
# the counter hash and the mantissa fill, by instruction class: (slots,
# thread-operations per clock per SM on compute capability 9.0, None where
# the class has no row of its own and is priced only through the issue
# limit). A copy of the counts the system published for its kernel on an
# H100 (sm_90); they are a floor of the compiled tick loop.
LANE_TICK_OPS = {
    "int32 multiply-add": (3, 64),
    "int32 shift": (3, 64),
    "int32 logic": (3, 64),
    "int32 shift-add": (1, 64),
    "fp32 add": (9, 128),
    "compare": (12, 64),
    "fp32 round (ceil)": (2, None),
    "select": (11, None),
}


def init(like, value):
    """The paper's start, shaped like ``like``: m = ``value``, step 1,
    sign +1."""
    return (torch.zeros_like(like) + value, torch.ones_like(like),
            torch.ones_like(like))


def tick(planes, x, u, q):
    """One tick of every lane: item ``x``, uniform ``u``, target ``q``."""
    m, step, sign = planes
    one = torch.ones_like(m)
    up = (x > m) & (u > 1 - q)
    down = (x < m) & (u > q)

    step_u = step + torch.where(sign > 0, one, -one)                # line 5
    m_u = m + torch.where(step_u > 0, torch.ceil(step_u), one)      # line 6
    osh_u = m_u > x                                                 # line 7
    step_u = torch.where(osh_u, step_u + (x - m_u), step_u)         # line 8
    m_u = torch.where(osh_u, x, m_u)                                # line 9
    step_u = torch.where((sign < 0) & (step_u > 1), one, step_u)    # 11-13

    step_d = step + torch.where(sign < 0, one, -one)                # line 16
    m_d = m - torch.where(step_d > 0, torch.ceil(step_d), one)      # line 17
    osh_d = m_d < x                                                 # line 18
    step_d = torch.where(osh_d, step_d + (m_d - x), step_d)         # line 19
    m_d = torch.where(osh_d, x, m_d)                                # line 20
    step_d = torch.where((sign > 0) & (step_d > 1), one, step_d)    # 22-24

    m2 = torch.where(up, m_u, torch.where(down, m_d, m))
    step2 = torch.where(up, step_u, torch.where(down, step_d, step))
    sign2 = torch.where(up, one, torch.where(down, -one, sign))
    return m2, step2, sign2


# The (step, sign) word keeps a normal |step| in [2^-63, 2^32) exactly;
# a NaN or smaller |step| (zero included) comes back as +0 with its sign,
# and a larger one as the largest float32 below 2^32 of its sign.
_MAX_STEP = 4294967040.0          # float32(2^32 * (1 - 2^-24))
_MIN_NORMAL_STEP = 2.0 ** -63


def canonical(planes):
    """The planes as they come back from the two-word state a dense call
    stores: the guarantee of two words a lane."""
    m, step, sign = planes
    zero = torch.zeros_like(step)
    step = torch.where(step > _MAX_STEP, zero + _MAX_STEP, step)
    step = torch.where(step < -_MAX_STEP, zero - _MAX_STEP, step)
    # NaN, zeros of either sign and tiny steps all come back as +0.
    small = (abs(step) < _MIN_NORMAL_STEP) | (step != step)
    return m, torch.where(small, zero, step), sign


def query(planes):
    """The estimate of every lane."""
    return planes[0]
