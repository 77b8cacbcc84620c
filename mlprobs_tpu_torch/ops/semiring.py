"""Log/tropical-semiring primitives for row-scan dynamic programs.

The row-scan formulation of the pair-HMM and partition-function DPs
walks the rows in order.  Within a row, states that consume the column
sequence satisfy a first-order affine recurrence

    u_j = (c_j) OPLUS (d_j OTIMES u_{j-1})

over the log semiring (OPLUS = logaddexp, OTIMES = +) or the tropical
semiring (OPLUS = max).  Affine maps compose associatively:

    (c2, d2) . (c1, d1) = (c2 OPLUS (d2 OTIMES c1), d2 OTIMES d1)

so a whole row resolves in ceil(log2 L) steps of tensor ops (a
Hillis-Steele scan over the composed pairs).  The PyTorch twin of the
JAX package's `ops/semiring.py`, whose scans are `lax.associative_scan`:
the two compose the maps in other trees, so they agree to f32 rounding.
"""
from __future__ import annotations

import torch

# Finite stand-in for log(0); safe under f32 accumulation through
# O(log L) compositions (|LOG_ZERO| * 2^depth << f32 max).
LOG_ZERO = -1e30


def logaddexp(a, b):
    return torch.logaddexp(a, b)


def logsumexp(xs, dim=None):
    """log(sum(exp(xs))) over `dim`, or over every element."""
    if dim is None:
        return torch.logsumexp(xs.reshape(-1), dim=0)
    return torch.logsumexp(xs, dim=dim)


def _affine_scan(c, d, oplus, reverse, dim):
    """Inclusive scan of the affine maps (c_j, d_j) along `dim`: entry j
    becomes the composition of the maps up to j (from j on, reversed)."""
    c = c.movedim(dim, -1)
    d = d.movedim(dim, -1)
    if reverse:
        c, d = c.flip(-1), d.flip(-1)
    n, k = c.shape[-1], 1
    while k < n:
        c_new = oplus(c[..., k:], d[..., k:] + c[..., :-k])
        c = torch.cat([c[..., :k], c_new], dim=-1)
        d = torch.cat([d[..., :k], d[..., :-k] + d[..., k:]], dim=-1)
        k *= 2
    if reverse:
        c, d = c.flip(-1), d.flip(-1)
    return c.movedim(-1, dim), d.movedim(-1, dim)


def affine_scan_log(c, d, init=None, reverse: bool = False, dim: int = -1):
    """Solve u_j = logaddexp(c_j, d_j + u_(j-1)) along `dim`.

    With reverse=True solves u_j = logaddexp(c_j, d_j + u_(j+1)).
    `init` is the value of u just outside the scanned range (defaults to
    LOG_ZERO, i.e. no inflow).
    """
    cc, dd = _affine_scan(c, d, torch.logaddexp, reverse, dim)
    if init is None:
        return cc
    return torch.logaddexp(cc, dd + init)


def affine_scan_max(c, d, init=None, reverse: bool = False, dim: int = -1):
    """Tropical-semiring version: u_j = max(c_j, d_j + u_(j-1))."""
    cc, dd = _affine_scan(c, d, torch.maximum, reverse, dim)
    if init is None:
        return cc
    return torch.maximum(cc, dd + init)


def shift_right(row, fill=LOG_ZERO):
    """[a,b,c] -> [fill,a,b] along the last axis."""
    return torch.cat([torch.full_like(row[..., :1], fill), row[..., :-1]],
                     dim=-1)


def shift_left(row, fill=LOG_ZERO):
    """[a,b,c] -> [b,c,fill] along the last axis."""
    return torch.cat([row[..., 1:], torch.full_like(row[..., :1], fill)],
                     dim=-1)
