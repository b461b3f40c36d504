"""Similarity metrics from the paper (the reference's ``core/similarity.py``).

Eq. 1 — total-variation similarity between attention probability matrices:
    SC(A, A') = 1 - (1/L) Σ_p ½ ‖A[p,:] − A'[p,:]‖₁   ∈ [0, 1]
"""
from __future__ import annotations

import torch


def similarity_score(a, a_prime):
    """TV similarity. (L, L) or (H, L, L) → scalar (head-averaged);
    (B, H, L, L) → (B,): the batch dimension replaces the reference's
    ``vmap``."""
    tv = 0.5 * torch.sum(torch.abs(a.float() - a_prime.float()), dim=-1)
    if a.ndim <= 3:
        return 1.0 - torch.mean(tv)
    return 1.0 - torch.mean(tv, dim=tuple(range(1, a.ndim - 1)))

