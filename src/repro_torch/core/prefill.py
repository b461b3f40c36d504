"""Prefill memoization — KV-bearing memo entries (AttnCache; DESIGN.md
§2.13), the counterpart of the reference's ``core/prefill.py``.

A prefill hit must hand back more than the attention output: decode
needs the layer's K/V cache, so a memo entry becomes "APM + per-layer
K/V". ``PrefillCodec`` wraps any base APM codec and APPENDS the KV parts
after the base parts, so every consumer of the parts tuple (host and
device arenas, delta sync, the capacity tier, save files, per-row
CRC32s) carries KV unchanged, and the kernels that index the base parts
positionally (int8 codes and scales) stay valid.

KV layout per entry: one stacked plane ``(2, S, D)`` — plane 0 is K,
plane 1 is V, ``S`` the arena (calibration) length, ``D = n_kv_heads ·
head_dim``. K is stored post-RoPE at positions from 0 (what
``gqa_prefill_cache`` caches), so it drops into a decode cache as is;
rows past an entry's true length are zero.

KV modes mirror the APM codecs: ``f16`` identity, ``int8`` per-row
symmetric (rows are the D-vectors of one position and plane), and
``lowrank`` an SVD of each ``(S, D)`` plane with int8 factors.
``kv_codec="auto"`` follows the base codec (f16 → f16, else int8).

``encode`` and ``decode_kv`` are numpy copies of the reference, so the
encoded bytes are identical across the packages. ``decode_kv_rows`` is
torch on the parts' device: bit-equal to ``decode_kv`` for f16 and int8;
for lowrank the factor product sums in another order (within one f16
ulp, as ``LowRankCodec.decode_rows``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.codec import ApmCodec, PartSpec, _quantize_rows


def _kv_mode(base_name: str, kv_codec: str,
             kv_rank: Optional[int]) -> str:
    """Resolve the KV storage mode. An explicit rank opts into lowrank."""
    if kv_codec == "auto":
        if kv_rank is not None:
            return "lowrank"
        return "f16" if base_name == "f16" else "int8"
    return kv_codec


class PrefillCodec(ApmCodec):
    """Base APM codec + appended K/V parts (one memo entry serves both
    the memoized attention and the decode cache)."""

    def __init__(self, base: ApmCodec, kv_dim: int, *,
                 kv_codec: str = "auto", kv_rank: Optional[int] = None):
        super().__init__(base.apm_shape)
        self.base = base
        self.kv_dim = int(kv_dim)
        self.seq_len = int(self.apm_shape[-1])
        self.kv_mode = _kv_mode(base.name, kv_codec, kv_rank)
        if self.kv_mode not in ("f16", "int8", "lowrank"):
            raise ValueError(f"unknown kv codec {self.kv_mode!r} "
                             "(f16 | int8 | lowrank)")
        lim = min(self.seq_len, self.kv_dim)
        self.kv_rank = (min(lim, max(1, int(kv_rank))) if kv_rank
                        else min(lim, max(4, lim // 8)))
        self.n_base_parts = len(base.parts)

    # the wrapped codec's name is THE codec name: the kernel path branches
    # on it positionally (parts[0]/parts[1]), which stays valid because
    # the KV parts come after the base parts
    @property
    def name(self):  # type: ignore[override]
        return self.base.name

    @property
    def key(self):
        kv = (self.kv_mode, self.kv_dim,
              self.kv_rank if self.kv_mode == "lowrank" else None)
        return ("prefill", self.base.key, kv)

    @property
    def parts(self) -> Tuple[PartSpec, ...]:
        s, d = self.seq_len, self.kv_dim
        if self.kv_mode == "f16":
            kv = (PartSpec("kv", (2, s, d), np.dtype(np.float16)),)
        elif self.kv_mode == "int8":
            kv = (PartSpec("kv", (2, s, d), np.dtype(np.int8)),
                  PartSpec("kv_scale", (2, s), np.dtype(np.float16)))
        else:
            r = self.kv_rank
            kv = (PartSpec("kv_u", (2, s, r), np.dtype(np.int8)),
                  PartSpec("kv_us", (2, s), np.dtype(np.float16)),
                  PartSpec("kv_v", (2, r, d), np.dtype(np.int8)),
                  PartSpec("kv_vs", (2, r), np.dtype(np.float16)))
        return self.base.parts + kv

    # ------------------------------------------------------------- encode
    def encode(self, apms, aux=None):
        """``aux``: the stacked KV plane (B, 2, S, D) — K post-RoPE in
        plane 0, V in plane 1, zero past each entry's true length.
        ``None`` stores zero KV (APM-only admissions; the engine gates
        prefill capture to KV-bearing batches)."""
        base_parts = self.base.encode(apms)
        b = np.asarray(apms).shape[0]
        if aux is None:
            kv = np.zeros((b, 2, self.seq_len, self.kv_dim), np.float32)
        else:
            kv = np.asarray(aux, np.float32)
            if kv.shape != (b, 2, self.seq_len, self.kv_dim):
                raise ValueError(
                    f"kv aux shape {kv.shape} != "
                    f"{(b, 2, self.seq_len, self.kv_dim)}")
        if self.kv_mode == "f16":
            kv_parts = (kv.astype(np.float16),)
        elif self.kv_mode == "int8":
            kv_parts = _quantize_rows(kv)
        else:
            r = self.kv_rank
            u, s, vt = np.linalg.svd(kv, full_matrices=False)
            root = np.sqrt(s[..., :r])
            uf = u[..., :, :r] * root[..., None, :]      # (B, 2, S, r)
            vf = vt[..., :r, :] * root[..., :, None]     # (B, 2, r, D)
            uq, us = _quantize_rows(uf)
            vq, vs = _quantize_rows(vf)
            kv_parts = (uq, us, vq, vs)
        return base_parts + kv_parts

    # ------------------------------------------------------------- decode
    def decode(self, parts):
        """Host decode keeps the base contract: parts → f16 APMs (the KV
        suffix is ignored; ``decode_kv`` is the explicit read)."""
        return self.base.decode(tuple(parts)[: self.n_base_parts])

    def decode_rows(self, parts):
        return self.base.decode_rows(tuple(parts)[: self.n_base_parts])

    def _kv_parts(self, parts):
        kv = tuple(parts)[self.n_base_parts:]
        if not kv:
            raise ValueError("parts tuple carries no KV suffix")
        return kv

    def decode_kv(self, parts) -> np.ndarray:
        """Host KV decode: numpy parts → (B, 2, S, D) f16 planes."""
        kv = self._kv_parts(parts)
        if self.kv_mode == "f16":
            return np.asarray(kv[0])
        if self.kv_mode == "int8":
            codes, scales = kv
            return (np.asarray(codes, np.float32)
                    * np.asarray(scales, np.float32)[..., None]
                    ).astype(np.float16)
        uq, us, vq, vs = kv
        u = np.asarray(uq, np.float32) * np.asarray(us, np.float32)[..., None]
        v = np.asarray(vq, np.float32) * np.asarray(vs, np.float32)[..., None]
        return np.einsum("...sr,...rd->...sd", u, v).astype(np.float16)

    def decode_kv_rows(self, parts) -> torch.Tensor:
        """Device KV decode: tensor parts → (B, 2, S, D) f16, op for op
        like ``decode_kv``."""
        kv = self._kv_parts(parts)
        if self.kv_mode == "f16":
            return kv[0]
        if self.kv_mode == "int8":
            codes, scales = kv
            return (codes.float() * scales.float()[..., None]).half()
        uq, us, vq, vs = kv
        u = uq.float() * us.float()[..., None]
        v = vq.float() * vs.float()[..., None]
        return torch.einsum("...sr,...rd->...sd", u, v).half()


def stack_kv(k, v):
    """(B, S, Hkv, dh) K and V → the stored (B, 2, S, Hkv·dh) plane
    (numpy arrays or tensors)."""
    if isinstance(k, torch.Tensor):
        b, s = k.shape[0], k.shape[1]
        return torch.stack([k.reshape(b, s, -1), v.reshape(b, s, -1)], 1)
    k = np.asarray(k)
    b, s = k.shape[0], k.shape[1]
    return np.stack([k.reshape(b, s, -1),
                     np.asarray(v).reshape(b, s, -1)], axis=1)


def unstack_kv_rows(kv: torch.Tensor, n_kv_heads: int,
                    head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``stack_kv``: (B, 2, S, D) → K, V each (B, S, Hkv, dh)
    — the decode-cache layout ``gqa_decode`` consumes."""
    b, _, s, _ = kv.shape
    shaped = kv.reshape(b, 2, s, n_kv_heads, head_dim)
    return shaped[:, 0], shaped[:, 1]
