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


def ordered_key(d2, idx):
    """The kernel's 64-bit key of (d2, idx), as int64: (ordered_bits(d2)
    << 32) | idx, less 2**63 so that int64 order is the kernel's unsigned
    order, which is the lexicographic (d2, idx) order. ordered_bits flips
    the sign bit of a non-negative float and every bit of a negative one;
    -0.0 is made +0.0 first."""
    u = (d2.float() + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    o = torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 2 ** 31)
    return ((o - 2 ** 31) << 32) | idx.to(torch.int64)


def decode_key(key):
    """(d2 f32, idx int32) of ``ordered_key``'s keys."""
    o = (key >> 32) + 2 ** 31
    u = torch.where(o >= 2 ** 31, o & 0x7FFFFFFF, o ^ 0xFFFFFFFF)
    d2 = (u - (u >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)
    return d2.view(torch.float32), (key & 0xFFFFFFFF).to(torch.int32)


def blocked_top1(d2, n_ranges, tile_rows=64):
    """The kernel's schedule on a (B, N) distance matrix: N cut into
    ``n_ranges`` ranges of whole ``tile_rows``-row tiles (range r holds
    tiles [T*r // R, T*(r+1) // R)), each range's (d2, idx) per query,
    folded across ranges by the minimum of their ``ordered_key``."""
    B, N = d2.shape
    n_tiles = -(-N // tile_rows)
    best = torch.full((B,), torch.iinfo(torch.int64).max, dtype=torch.int64)
    for r in range(n_ranges):
        lo = n_tiles * r // n_ranges * tile_rows
        hi = min(N, n_tiles * (r + 1) // n_ranges * tile_rows)
        if lo >= hi:
            continue
        block = d2[:, lo:hi] + 0.0
        i = torch.argmin(block, -1)
        key = ordered_key(block.gather(1, i[:, None])[:, 0], i + lo)
        best = torch.minimum(best, key)
    return decode_key(best)


def nn_search_blocked_ref(q, db, db_norms=None, *, n_ranges, tile_rows=64):
    """``nn_search_ref`` through the kernel's schedule (``blocked_top1``):
    the same (d2, idx), since the key order is argmin's tie rule."""
    return blocked_top1(sq_dists(q, db, db_norms), n_ranges, tile_rows)
