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


def wkv6_chunked_schedule_ref(r, k, v, w, u, chunk):
    """The kernel's three-phase schedule (``csrc/rwkv6.cu``) in plain
    PyTorch, for tests: the sequence cut into chunks of ``chunk`` steps.

    1. each chunk c but the last, from a zero state: its end state U_c
       (k, v and w only) and its decay D_c = prod of w over the chunk;
    2. the scan over chunks, H_c = diag(D_c) H_{c-1} + U_c (H_{-1} = 0):
       the state entering chunk c + 1;
    3. each chunk's outputs from the state entering it.

    Same arguments and result as ``wkv6_ref``."""
    B, S, nh, N = r.shape
    dtype = r.dtype
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    zero = torch.zeros((B, nh, N, N), dtype=torch.float32, device=r.device)
    spans = [slice(t0, min(t0 + chunk, S)) for t0 in range(0, S, chunk)]
    ends, decays = [], []
    for sl in spans[:-1]:                                       # phase 1
        s, d = zero, torch.ones((B, nh, N), device=r.device)
        for t in range(sl.start, sl.stop):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]
            s = w[:, t, :, :, None] * s + kv
            d = d * w[:, t]
        ends.append(s)
        decays.append(d)
    entering, s = [zero], zero
    for d, end in zip(decays, ends):                            # phase 2
        s = d[..., None] * s + end
        entering.append(s)
    outs = [wkv_scan(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, s0)[0]
            for sl, s0 in zip(spans, entering)]                 # phase 3
    return torch.cat(outs, 1).to(dtype) if outs else r.to(dtype)
