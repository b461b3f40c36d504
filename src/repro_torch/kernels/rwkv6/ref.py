"""Plain PyTorch version of the rwkv6 wkv kernel: the sequential
recurrence of the reference's ``kernels/rwkv6/ref.py::wkv6_ref`` and
``models/rwkv.py::_wkv_scan``, in the model layout."""
from __future__ import annotations

import torch


def wkv_scan(r, k, v, w, u, s0):
    """r,k,v,w (B,S,nh,N); u (nh,N); s0 (B,nh,N,N) → o (B,S,nh,N), sT.
    o_t = r_t·(S_t + diag(u) k_t v_tᵀ), S_{t+1} = diag(w_t) S_t + k_t v_tᵀ.
    """
    s = s0
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # outer product
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, 1), s


def wkv6_ref(r, k, v, w, u):
    """The wkv output from a zero state: r,k,v,w (B,S,nh,N), u (nh,N) →
    o (B,S,nh,N), computed in f32 and returned in r's dtype."""
    B, _, nh, N = r.shape
    s0 = torch.zeros((B, nh, N, N), dtype=torch.float32, device=r.device)
    o, _ = wkv_scan(r.float(), k.float(), v.float(), w.float(), u.float(),
                    s0)
    return o.to(r.dtype)
