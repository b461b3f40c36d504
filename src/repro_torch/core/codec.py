"""APM codecs — compressed storage formats for both memo tiers (the
reference's ``core/codec.py``).

* ``f16``     — identity: one float16 arena.
* ``int8``    — symmetric per-row int8 codes with float16 scales.
* ``lowrank`` — rank-r factors APM ≈ U·Vᵀ (√Σ split between them), each
                factor per-row int8 with float16 scales: four parts.

Host ``encode``/``decode`` are numpy copies of the reference, so encoded
bytes are identical across the two packages. ``decode_rows`` is torch on
whatever device the parts live and performs the reference's
float32-multiply → float16-round sequence: bit-equal to ``decode`` for
``int8``; for ``lowrank`` the factor product sums in another order, so
the two agree within float tolerance (one f16 ulp after the round).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PartSpec:
    """One arena of a codec: per-entry shape suffix + storage dtype."""
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype

    @property
    def entry_nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


def _quantize_rows(x: np.ndarray):
    """Symmetric per-row int8: x (..., n) → (codes int8 (..., n),
    scales f16 (...)). The f16-rounded scale is the one used for
    encoding, so decode(encode(x)) is exactly reproducible."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = np.maximum(amax / 127.0, 1e-4).astype(np.float16)
    codes = np.clip(np.rint(x / scale.astype(np.float32)[..., None]),
                    -127, 127).astype(np.int8)
    return codes, scale


class ApmCodec:
    """Base: a codec is its part specs + encode/decode both ways."""

    name = "abstract"

    def __init__(self, apm_shape: Tuple[int, ...]):
        self.apm_shape = tuple(apm_shape)

    @property
    def parts(self) -> Tuple[PartSpec, ...]:
        raise NotImplementedError

    @property
    def entry_nbytes(self) -> int:
        return sum(p.entry_nbytes for p in self.parts)

    @property
    def key(self):
        return (self.name, self.apm_shape)

    def encode(self, apms: np.ndarray, aux=None) -> Tuple[np.ndarray, ...]:
        raise NotImplementedError

    def decode(self, parts) -> np.ndarray:
        """Host decode: numpy parts (B, ...) → f16 APMs (B, *apm_shape)."""
        raise NotImplementedError

    def decode_rows(self, parts):
        """Device decode: tensor parts → f16 APM rows, op for op like
        ``decode``."""
        raise NotImplementedError


class F16Codec(ApmCodec):
    """Identity storage (optionally in a caller-chosen dtype)."""

    name = "f16"

    def __init__(self, apm_shape, dtype=np.float16):
        super().__init__(apm_shape)
        self.dtype = np.dtype(dtype)

    @property
    def parts(self):
        return (PartSpec("apm", self.apm_shape, self.dtype),)

    def encode(self, apms, aux=None):
        return (np.asarray(apms, self.dtype),)

    def decode(self, parts):
        return np.asarray(parts[0])

    def decode_rows(self, parts):
        return parts[0]


class Int8Codec(ApmCodec):
    """Symmetric per-row int8 codes + per-row f16 scales."""

    name = "int8"

    @property
    def parts(self):
        h, l, _ = self.apm_shape
        return (PartSpec("codes", self.apm_shape, np.dtype(np.int8)),
                PartSpec("scales", (h, l), np.dtype(np.float16)))

    def encode(self, apms, aux=None):
        return _quantize_rows(np.asarray(apms, np.float32))

    def decode(self, parts):
        codes, scales = parts
        return (np.asarray(codes, np.float32)
                * np.asarray(scales, np.float32)[..., None]
                ).astype(np.float16)

    def decode_rows(self, parts):
        codes, scales = parts
        return (codes.float() * scales.float()[..., None]).half()


class LowRankCodec(ApmCodec):
    """Rank-r factorization with int8-quantized factors: APM ≈ U·Vᵀ where
    U, V absorb √Σ from the SVD, each factor row per-row int8 quantized.
    Decoded rows sum to 1 only approximately (the truncated singular
    mass); the memo kernel does not renormalize them."""

    name = "lowrank"

    def __init__(self, apm_shape, rank=None):
        super().__init__(apm_shape)
        l = self.apm_shape[-1]
        # clamp to [1, L]: an (L, L) matrix has L singular values
        self.rank = min(l, max(1, int(rank))) if rank else min(
            l, max(4, l // 8))

    @property
    def key(self):
        return (self.name, self.apm_shape, self.rank)

    @property
    def parts(self):
        h, l, _ = self.apm_shape
        r = self.rank
        return (PartSpec("u", (h, l, r), np.dtype(np.int8)),
                PartSpec("us", (h, l), np.dtype(np.float16)),
                PartSpec("v", (h, l, r), np.dtype(np.int8)),
                PartSpec("vs", (h, l), np.dtype(np.float16)))

    def encode(self, apms, aux=None):
        x = np.asarray(apms, np.float32)
        u, s, vt = np.linalg.svd(x)                    # batched over (B, H)
        r = self.rank
        root = np.sqrt(s[..., :r])
        uf = u[..., :, :r] * root[..., None, :]        # (..., L, r)
        vf = np.swapaxes(vt[..., :r, :], -1, -2) * root[..., None, :]
        uq, us = _quantize_rows(uf)
        vq, vs = _quantize_rows(vf)
        return uq, us, vq, vs

    def decode(self, parts):
        uq, us, vq, vs = parts
        u = np.asarray(uq, np.float32) * np.asarray(us, np.float32)[..., None]
        v = np.asarray(vq, np.float32) * np.asarray(vs, np.float32)[..., None]
        return np.einsum("...qr,...kr->...qk", u, v).astype(np.float16)

    def decode_rows(self, parts):
        uq, us, vq, vs = parts
        u = uq.float() * us.float()[..., None]
        v = vq.float() * vs.float()[..., None]
        return torch.einsum("...qr,...kr->...qk", u, v).half()


from repro_torch.core.registry import CODECS  # noqa: E402

CODECS.register("f16",
                lambda shape, *, rank=None, dtype=np.float16, **_:
                F16Codec(shape, dtype=dtype))
CODECS.register("int8",
                lambda shape, *, rank=None, dtype=None, **_:
                Int8Codec(shape))
CODECS.register("lowrank",
                lambda shape, *, rank=None, dtype=None, **_:
                LowRankCodec(shape, rank=rank))


def get_codec(name, apm_shape, *, rank=None, dtype=np.float16) -> ApmCodec:
    """Resolve a codec key through the registry; an ApmCodec instance
    passes through."""
    if isinstance(name, ApmCodec):
        return name
    if name in ("none", None):
        name = "f16"
    return CODECS.resolve(name)(apm_shape, rank=rank, dtype=dtype)
