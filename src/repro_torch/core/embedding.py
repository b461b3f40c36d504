"""Hidden-state embedding model + Siamese trainer (paper §5.2), the
counterpart of the reference's ``core/embedding.py``.

A lightweight 3-layer MLP maps a hidden state (L, H) to a 128-d feature
vector; training makes ‖e₁ − e₂‖₂ predict 1 − SC(APM₁, APM₂).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.similarity import pair_similarity
from repro_torch.models.layers import dense_init


@dataclass
class Embedder:
    params: dict
    pool: int              # token-pool stride before flatten
    act: str               # "linear" | "tanh"

    @staticmethod
    def init(gen: torch.Generator, seq_len: int, hidden: int, *,
             dim: int = 128, widths: Tuple[int, int] = (512, 256),
             pool: int = 8, act: str = "linear",
             device=None) -> "Embedder":
        """pool: mean-pool the token axis by this stride before the MLP so
        the input layer stays 'tens of thousands of neurons' (paper)."""
        pooled = max(1, seq_len // pool)
        d_in = pooled * hidden
        z = dict(dtype=torch.float32, device=device)
        params = {
            "w1": dense_init(gen, (d_in, widths[0]), device=device),
            "b1": torch.zeros((widths[0],), **z),
            "w2": dense_init(gen, (widths[0], widths[1]), device=device),
            "b2": torch.zeros((widths[1],), **z),
            "w3": dense_init(gen, (widths[1], dim), device=device),
            "b3": torch.zeros((dim,), **z),
        }
        return Embedder(params, pool, act)

    def __call__(self, hidden, lengths=None):
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=hidden.device)
        return embed_apply(self.params, hidden, self.pool, self.act,
                           lengths=lengths)


def _maybe_act(x, act):
    return torch.tanh(x) if act == "tanh" else x


def n_segments(params, hidden_dim: int) -> int:
    """The token-pool segment count the embedder was trained with."""
    return int(params["w1"].shape[0]) // int(hidden_dim)


def _masked_pool(hidden, lengths, n_seg: int, pool: int, full_len: int):
    """Length-scaled integer-chunk pooling (see the reference): each
    sequence's VALID prefix is split into ``n_seg`` chunks of
    ``max(1, len·pool // full_len)`` tokens and mean-pooled, so padded
    positions get weight 0 and a padded sequence embeds like its
    unpadded run."""
    B, L, H = hidden.shape
    ln = lengths.to(torch.int32)
    chunk = torch.clamp((ln * pool) // max(int(full_len), 1), min=1)  # (B,)
    t = torch.arange(L, dtype=torch.int32, device=hidden.device)
    seg = t[None, :] // chunk[:, None]                                # (B, L)
    valid = t[None, :] < torch.minimum(ln, chunk * n_seg)[:, None]
    segs = torch.arange(n_seg, device=hidden.device)
    w = ((seg[:, :, None] == segs[None, None, :])
         & valid[:, :, None]).float()                     # (B, L, n_seg)
    pooled = torch.einsum("bls,blh->bsh", w, hidden.float())
    return pooled / torch.clamp(w.sum(1), min=1.0)[:, :, None]


def embed_apply(params, hidden, pool: int, act: str, lengths=None,
                full_len=None):
    """hidden: (B, L, H) → (B, dim). With ``lengths`` (B,), pooling is
    mask-aware; ``full_len`` is the calibration sequence length the chunk
    scale is anchored to (default: ``n_seg·pool``)."""
    B, L, H = hidden.shape
    if lengths is None:
        pooled = max(1, L // pool)
        h = hidden[:, : pooled * pool].reshape(B, pooled, pool, H).mean(2)
    else:
        n_seg = n_segments(params, H)
        if full_len is None:
            full_len = n_seg * pool
        h = _masked_pool(hidden, lengths, n_seg, pool, full_len)
    h = h.reshape(B, -1).float()
    h = _maybe_act(h @ params["w1"] + params["b1"], act)
    h = _maybe_act(h @ params["w2"] + params["b2"], act)
    return h @ params["w3"] + params["b3"]


def siamese_loss(params, pair_a, pair_b, d_gt, pool, act):
    ea = embed_apply(params, pair_a, pool, act)
    eb = embed_apply(params, pair_b, pool, act)
    dist = torch.sqrt(torch.sum(torch.square(ea - eb), -1) + 1e-12)
    return torch.mean(torch.square(dist - d_gt))


def train_embedder(seed: int, embedder: Embedder, hiddens, apms, *,
                   steps=300, pair_batch=64, lr=1e-3
                   ) -> Tuple[Embedder, list]:
    """hiddens: (N, L, H); apms: (N, H_heads, L, L) tensors on one device.
    Pairs are drawn with a numpy generator seeded by ``seed``; gradients
    come from torch autograd. Returns trained embedder + loss history."""
    from repro_torch.optim.adamw import adamw_init, adamw_update

    n = hiddens.shape[0]
    params = {k: v.detach() for k, v in embedder.params.items()}
    opt_state = adamw_init(params)
    history = []
    rng = np.random.default_rng(int(seed))
    dev = hiddens.device
    for _ in range(steps):
        ia = torch.as_tensor(rng.integers(0, n, pair_batch), device=dev)
        ib = torch.as_tensor(rng.integers(0, n, pair_batch), device=dev)
        with torch.no_grad():
            d_gt = 1.0 - pair_similarity(apms, ia, ib)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = siamese_loss(leaves, hiddens[ia], hiddens[ib], d_gt,
                            embedder.pool, embedder.act)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params, opt_state = adamw_update(
            {k: v.detach() for k, v in leaves.items()}, grads, opt_state,
            lr=lr)
        history.append(float(loss.detach()))
    return Embedder(params, embedder.pool, embedder.act), history
