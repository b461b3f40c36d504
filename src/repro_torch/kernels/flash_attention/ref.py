"""Plain PyTorch version of flash_attention: the contract of the
reference's ``kernels/flash_attention/ops.py::flash_attention`` with the
kernel's masking convention (``kernel.py:45-50``, ``ref.py``'s final
``where``): f32 compute, −1e30 masking, fully masked rows zeroed."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_probs(q, k, *, causal, window, lengths=None):
    """Masked softmax probabilities, (B,Hkv,group,S,S) in f32, for
    q (B,S,H,dh) and k (B,S,Hkv,dh); query head h reads kv head
    h // group. ``lengths`` (B,) masks keys at or past each row's length.
    A fully masked row comes out all zeros."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, H // Hkv, S, dh)
    kf = k.float().permute(0, 2, 1, 3)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * dh ** -0.5
    qpos = torch.arange(S, device=dev)[:, None]
    kpos = torch.arange(S, device=dev)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = mask[None, None, None].expand(B, 1, 1, S, S)
    if lengths is not None:
        mask = mask & (torch.arange(S, device=dev)[None, :]
                       < lengths.to(dev)[:, None])[:, None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, -1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    return p / torch.clamp(torch.sum(p, -1, keepdim=True), min=1e-30)


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q (B,S,H,dh), k/v (B,S,Hkv,dh) → (B,S,H,dh)."""
    B, S, H, dh = q.shape
    p = attention_probs(q, k, causal=causal, window=window)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    return out.reshape(B, H, S, dh).permute(0, 2, 1, 3).to(q.dtype)
