"""Model interface over the backbone (the reference's ``models/model.py``
for decoder-only and encoder configs; enc-dec and prefill/decode come
with later slices)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import backbone as bb


class Model:
    def __init__(self, cfg, *, device=None):
        if cfg.encoder is not None:
            raise NotImplementedError(
                "encoder-decoder models (whisper) wait for the model-zoo "
                "slice")
        self.cfg = cfg
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

    def forward(self, params, batch, *, capture=False, memo_plan=None):
        """Returns (logits, apms, aux)."""
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, apms = bb.forward_hidden(params, h, self.cfg, mode="full",
                                    memo_plan=memo_plan, capture=capture)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return bb.logits_from_hidden(params, h, self.cfg), apms, aux

    def classify(self, params, batch, *, memo_plan=None, capture=False):
        """Mean-pool classification (AttMemo accuracy experiments)."""
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, apms = bb.forward_hidden(params, h, self.cfg, mode="full",
                                    memo_plan=memo_plan, capture=capture)
        logits = bb.classify_from_hidden(params, h, self.cfg)
        return (logits, apms) if capture else logits


def build_model(cfg, *, device=None) -> Model:
    return Model(cfg, device=device)
