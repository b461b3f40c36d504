"""Plain PyTorch version of nn_search — the reference's
``index.py::_sq_dists_cached`` (or ``_sq_dists``) plus argmin."""
from __future__ import annotations

import torch


def sq_dists(q, d, dn=None):
    """(B, N) squared L2 in the matmul form ‖q‖² − 2·q·dᵀ + ‖d‖²."""
    qn = torch.sum(q * q, -1, keepdim=True)
    if dn is None:
        dn = torch.sum(d * d, -1)
    return qn - 2.0 * (q @ d.T) + dn[None, :]


def nn_search_ref(q, db, db_norms=None):
    """Top-1: (squared dists (B,) f32, idx (B,) int32); ties → the lowest
    index (``argmin`` returns the first minimum)."""
    d2 = sq_dists(q, db, db_norms)
    idx = torch.argmin(d2, -1)
    return d2.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)
