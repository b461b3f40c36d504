"""Model interface over the backbone (the reference's ``models/model.py``
for decoder-only and encoder configs; enc-dec comes with the model-zoo
slice).

``attn_impl`` keeps the reference's name and picks what the
full-sequence forward and the prompt pass of ``prefill`` run in their
kernel-backed layers:

* ``"plain"`` — the reference's ``"xla"``: attention through ``_sdpa``,
  the rwkv6 mixer through ``_wkv_scan``;
* ``"kernel"`` — the reference's ``"pallas"`` / ``"pallas_interpret"``:
  the ``flash_attention`` and ``rwkv6`` kernel wrappers (CUDA kernels on
  CUDA tensors, their plain versions on CPU tensors). Attention keeps
  ``_sdpa`` where a memo, APM capture or a key-padding mask is in play,
  as the reference does; the rwkv6 mixer keeps the scan wherever it
  carries a state (prefill and decode), since the kernel starts from a
  zero state. ``decode_step`` is plain one-token attention either way.
  MLA layers run their plain form under both: the reference's
  ``mla_apply`` reaches no kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import backbone as bb


ATTN_IMPLS = ("plain", "kernel")


class Model:
    def __init__(self, cfg, *, device=None, attn_impl="plain"):
        if cfg.encoder is not None:
            raise NotImplementedError(
                "encoder-decoder models (whisper) wait for the model-zoo "
                "slice")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.is_encdec = False

    def init(self, seed: int = 0, dtype=torch.float32,
             generator: Optional[torch.Generator] = None):
        """Random params on ``self.device`` from ``seed`` (or an explicit
        generator on that device)."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return bb.backbone_init(gen, self.cfg, dtype, self.device)

    def _tokens(self, batch):
        return torch.as_tensor(batch["tokens"], device=self.device)

    def forward(self, params, batch, *, capture=False, memo_plan=None,
                window=None):
        """Returns (logits, apms, aux): ``aux`` is the summed MoE router
        load-balance loss (0 without MoE layers). ``window`` is a sliding
        window for attention layers of configs that set none."""
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, _, apms, aux = bb.forward_hidden(
            params, h, self.cfg, mode="full", memo_plan=memo_plan,
            capture=capture, window=window, attn_impl=self.attn_impl)
        return bb.logits_from_hidden(params, h, self.cfg), apms, aux

    def classify(self, params, batch, *, memo_plan=None, capture=False):
        """Mean-pool classification (AttMemo accuracy experiments)."""
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, _, apms, _ = bb.forward_hidden(
            params, h, self.cfg, mode="full", memo_plan=memo_plan,
            capture=capture, attn_impl=self.attn_impl)
        logits = bb.classify_from_hidden(params, h, self.cfg)
        return (logits, apms) if capture else logits

    def classify_loss(self, params, batch):
        """Mean cross-entropy of ``classify`` against ``batch["labels"]``
        (differentiable: call it with grad enabled)."""
        logits = self.classify(params, batch).float()
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return -torch.mean(torch.gather(F.log_softmax(logits, -1), -1,
                                        labels.long()[:, None]))

    # -- serving ---------------------------------------------------------------
    def init_caches(self, batch, cache_len, dtype=torch.float32,
                    window=None):
        return bb.init_caches(self.cfg, batch, cache_len, dtype,
                              window=window, device=self.device)

    def prefill(self, params, batch, *, cache_len, window=None,
                dtype=torch.float32):
        """Process the prompt; returns (last_token_logits, caches)."""
        tokens = self._tokens(batch)
        B = tokens.shape[0]
        caches = self.init_caches(B, cache_len, dtype, window=window)
        h = bb.embed_tokens(params, tokens, self.cfg)
        h, caches, _, _ = bb.forward_hidden(
            params, h, self.cfg, mode="prefill", caches=caches,
            window=window, attn_impl=self.attn_impl)
        logits = bb.logits_from_hidden(params, h[:, -1:], self.cfg)
        return logits[:, 0], caches

    def decode_step(self, params, tokens, caches, pos, *, window=None):
        """tokens: (B,1); ``pos``: the absolute position (an int or a 0-d
        tensor). Returns (logits (B,V), new_caches)."""
        h = bb.embed_tokens(params,
                            torch.as_tensor(tokens, device=self.device),
                            self.cfg)
        h, caches, _, _ = bb.forward_hidden(
            params, h, self.cfg, mode="decode", caches=caches, pos=pos,
            window=window, attn_impl=self.attn_impl)
        logits = bb.logits_from_hidden(params, h, self.cfg)
        return logits[:, 0], caches


def build_model(cfg, *, device=None, attn_impl="plain") -> Model:
    return Model(cfg, device=device, attn_impl=attn_impl)
