"""Plain PyTorch version of memo_attention — the reference's
``_memo_attention_xla`` (``kernels/memo_attention/ops.py``) line for line:
the miss rows' probabilities are flash_attention's plain version (f32,
−1e30 masking, fully masked rows zeroed), hits consume the raw APM rows
(no renormalisation), and one probs·V product serves both paths."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ref import attention_probs


def _fit_db(db, target: int, n_tail_dims: int):
    """Slice or zero-pad the trailing ``n_tail_dims`` sequence dims to
    ``target`` (stored APMs are hard zeros past their entry's length)."""
    L = db.shape[-1]
    if L == target:
        return db
    if L > target:
        sl = (Ellipsis,) + (slice(0, target),) * n_tail_dims
        return db[sl]
    return F.pad(db, (0, target - L) * n_tail_dims)


def memo_attention_ref(q, k, v, db_apm, hit_idx, hit, *, db_scales=None,
                       lengths=None, causal=True, window=None):
    """q (B,S,H,dh), k/v (B,S,Hkv,dh), db_apm (N,H,L,L) f16 (or int8 codes
    with ``db_scales`` (N,H,L) f16), hit_idx/hit/lengths (B,)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    dev = q.device
    p = attention_probs(q, k, causal=causal, window=window, lengths=lengths)
    vf = v.float().permute(0, 2, 1, 3)
    idx = torch.clamp(hit_idx.to(dev).long(), 0, db_apm.shape[0] - 1)
    apm = db_apm.index_select(0, idx).float()
    if db_scales is not None:
        apm = apm * db_scales.index_select(0, idx).float()[..., None]
    apm = _fit_db(apm, S, 2)
    p = torch.where((hit.to(dev) == 1)[:, None, None, None], apm,
                    p.reshape(B, H, S, S))
    out = torch.einsum("bhgqk,bhkd->bhgqd",
                       p.reshape(B, Hkv, H // Hkv, S, S), vf)
    return out.reshape(B, H, S, dh).permute(0, 2, 1, 3).to(q.dtype)
