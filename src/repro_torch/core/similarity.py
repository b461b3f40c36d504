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



# elements of one (B, H, L, L) APM pair block that ``pair_similarity``
# hands ``similarity_score`` at once: a whisper encoder entry is 16 x
# 1500^2 = 36 M values, so the 256 calibration pairs would need ~110 GB
# of f32 temporaries in one call
PAIR_CHUNK_ELEMS = 1 << 28


def pair_similarity(apms, ia, ib):
    """``similarity_score(apms[ia], apms[ib])`` for index tensors ia, ib,
    in chunks of at most PAIR_CHUNK_ELEMS elements a side; each pair's
    value is the same whatever the chunking."""
    per = max(1, apms[0].numel())
    step = max(1, PAIR_CHUNK_ELEMS // per)
    return torch.cat([similarity_score(apms[ia[i:i + step]],
                                       apms[ib[i:i + step]])
                      for i in range(0, len(ia), step)])
