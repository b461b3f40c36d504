"""Shared neural building blocks (functions over dicts of tensors), the
counterpart of the reference's ``models/layers.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None):
    """Truncated-normal fan-in init (shape[0] or explicit scale): a
    standard normal cut at ±2, times the std — the reference's rule; the
    numbers differ from ``jax.random`` for the same seed."""
    std = scale if scale is not None else shape[0] ** -0.5
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (out * std).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype=torch.float32,
               device=None):
    out = torch.empty((vocab, d), dtype=torch.float32, device=device)
    out.normal_(0.0, 1.0, generator=gen)
    return (out * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_init(d, kind: str, dtype=torch.float32, device=None):
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def norm_apply(params, x, kind: str, eps: float = 1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (xf * params["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, dh) or (..., S, dh); positions: (..., S)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)                  # (dh/2,)
    ang = positions.float()[..., None] * inv                       # (..., S, dh/2)
    if x.ndim == ang.ndim + 1:                                     # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

# jax.nn.gelu defaults to the tanh approximation
_ACT = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def mlp_init(gen, d, d_ff, glu: bool, dtype=torch.float32, device=None):
    if glu:
        return {"w_gate": dense_init(gen, (d, d_ff), dtype=dtype,
                                     device=device),
                "w_up": dense_init(gen, (d, d_ff), dtype=dtype,
                                   device=device),
                "w_down": dense_init(gen, (d_ff, d), dtype=dtype,
                                     device=device)}
    return {"w_up": dense_init(gen, (d, d_ff), dtype=dtype, device=device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_down": dense_init(gen, (d_ff, d), dtype=dtype, device=device),
            "b_down": torch.zeros((d,), dtype=dtype, device=device)}


def mlp_apply(params, x, act: str, glu: bool):
    f = _ACT[act]
    if glu:
        h = f(x @ params["w_gate"]) * (x @ params["w_up"])
        return h @ params["w_down"]
    h = f(x @ params["w_up"] + params["b_up"])
    return h @ params["w_down"] + params["b_down"]


# ---------------------------------------------------------------------------
# mesh specs: logical-axis names mirroring each init's tree
# ---------------------------------------------------------------------------

def mlp_specs(glu: bool):
    """Logical-axis names mirroring mlp_init."""
    if glu:
        return {"w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
                "w_down": ("ff", "embed")}
    return {"w_up": ("embed", "ff"), "b_up": ("ff",),
            "w_down": ("ff", "embed"), "b_down": ("embed",)}


def norm_specs(kind: str):
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    return {"scale": ("embed",), "bias": ("embed",)}
