"""Model interface over the backbone and the encoder-decoder assembly
(the reference's ``models/model.py``): decoder-only, encoder-only and
hybrid configs through ``models/backbone.py``, enc-dec (whisper) through
``models/encdec.py``, whose batches also carry ``frames`` (B, F, d_enc).

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
  ``mla_apply`` reaches no kernel. RG-LRU layers run their scan under
  both (the reference's is ``lax.scan``, outside any kernel). In an
  enc-dec model the kernel runs in the encoder (bidirectional) and in
  the decoder's self-attention over the prompt (causal); the reference
  reaches it in its encoder only, the same values within f32 rounding.

``mesh`` (a ``ModelMesh``, ``launch/mesh.py``) reaches every MoE layer
of ``forward``, ``train_loss``, ``classify``, ``prefill`` and
``decode_step``, which then runs the expert-parallel ``moe_apply_ep``
over the mesh's devices, capacity drops included, with the tokens split
over ``dp_axes_of(mesh)``. Every other layer runs on the mesh's lead device (the model's
``device``): the reference leaves those layers to GSPMD, whose placement
changes no value. ``specs()`` is the params tree's logical-axis names
for ``sharding/rules.py``.

``remat`` runs each layer of the full-sequence forward under activation
checkpointing (the reference's ``remat``). ``train_loss`` and
``classify_loss`` are differentiable under ``attn_impl="plain"`` only:
the kernels have no backward (nor have the reference's Pallas kernels),
so under ``"kernel"`` both raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import dp_axes_of, indexed_device
from repro_torch.models import backbone as bb
from repro_torch.models import encdec as ed


ATTN_IMPLS = ("plain", "kernel")


class Model:
    def __init__(self, cfg, *, device=None, mesh=None, attn_impl="plain",
                 remat=False, max_seq=4096):
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.remat = remat
        self.mesh = mesh
        self.dp_axes = ("data",)
        if mesh is not None:
            self.dp_axes = dp_axes_of(mesh)
            lead = mesh.lead               # an abstract mesh raises here
            if (device is not None
                    and indexed_device(torch.device(device)) != lead):
                raise ValueError(f"device {device} is not the mesh's lead "
                                 f"device {lead}")
            device = lead
        self.device = resolve_device(device)
        self.max_seq = max_seq          # enc-dec: rows of dec_pos
        self.is_encdec = cfg.encoder is not None
        if self.is_encdec:
            self._ecfg = ed.encoder_cfg(cfg)

    def init(self, seed: int = 0, dtype=torch.float32,
             generator: Optional[torch.Generator] = None):
        """Random params on ``self.device`` from ``seed`` (or an explicit
        generator on that device)."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        if self.is_encdec:
            return ed.encdec_init(gen, self.cfg, self.max_seq, dtype,
                                  self.device)[0]
        return bb.backbone_init(gen, self.cfg, dtype, self.device)

    def specs(self):
        """Logical-axis names mirroring ``init``'s tree (one tuple a leaf,
        its length the leaf's rank)."""
        if self.is_encdec:
            return ed.encdec_specs(self.cfg)
        return bb.backbone_specs(self.cfg)

    def _mesh_kw(self):
        return dict(mesh=self.mesh, dp_axes=self.dp_axes)

    def _tokens(self, batch):
        return torch.as_tensor(batch["tokens"], device=self.device)

    def _encode(self, params, batch, **kw):
        frames = torch.as_tensor(batch["frames"], device=self.device)
        return ed.encode(params, frames, self.cfg, self._ecfg,
                         attn_impl=self.attn_impl, **kw)

    def _encdec_logits(self, params, h):
        h = bb.norm_apply(params["final_norm"], h, self.cfg.norm)
        return h @ params["embed"].T

    def forward(self, params, batch, *, capture=False, memo_plan=None,
                window=None):
        """Returns (logits, apms, aux): ``aux`` is the summed MoE router
        load-balance loss (0 without MoE layers). ``window`` is a sliding
        window for attention layers of configs that set none. An enc-dec
        model captures and memoizes its encoder layers."""
        if self.is_encdec:
            enc_h, apms = self._encode(params, batch, capture=capture,
                                       memo_plan=memo_plan)
            h, _ = ed.decode_tokens(params, self._tokens(batch), enc_h,
                                    self.cfg, mode="full", window=window,
                                    attn_impl=self.attn_impl,
                                    remat=self.remat)
            return (self._encdec_logits(params, h), apms,
                    torch.zeros((), dtype=torch.float32, device=h.device))
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, _, apms, aux = bb.forward_hidden(
            params, h, self.cfg, mode="full", memo_plan=memo_plan,
            capture=capture, window=window, attn_impl=self.attn_impl,
            remat=self.remat, **self._mesh_kw())
        return bb.logits_from_hidden(params, h, self.cfg), apms, aux

    def _differentiable(self, what):
        if self.attn_impl != "plain":
            raise NotImplementedError(
                f"{what} under attn_impl={self.attn_impl!r}: the kernels "
                f"have no backward, as the reference's Pallas kernels have "
                f"no gradient; train with attn_impl='plain'")

    def train_loss(self, params, batch):
        """Mean next-token NLL over ``logits[:, :-1]`` in f32, plus
        ``aux_loss_coef`` times the MoE router aux where the config has
        a MoE (differentiable: call it with grad enabled)."""
        self._differentiable("train_loss")
        logits, _, aux = self.forward(params, batch)
        tok = self._tokens(batch).long()
        logp = F.log_softmax(logits[:, :-1].float(), -1)
        loss = -torch.mean(torch.gather(logp, -1, tok[:, 1:, None]))
        if self.cfg.moe is not None:
            loss = loss + self.cfg.moe.aux_loss_coef * aux
        return loss

    def classify(self, params, batch, *, memo_plan=None, capture=False):
        """Mean-pool classification (AttMemo accuracy experiments)."""
        h = bb.embed_tokens(params, self._tokens(batch), self.cfg)
        h, _, apms, _ = bb.forward_hidden(
            params, h, self.cfg, mode="full", memo_plan=memo_plan,
            capture=capture, attn_impl=self.attn_impl, **self._mesh_kw())
        logits = bb.classify_from_hidden(params, h, self.cfg)
        return (logits, apms) if capture else logits

    def classify_loss(self, params, batch):
        """Mean cross-entropy of ``classify`` against ``batch["labels"]``
        (differentiable: call it with grad enabled)."""
        self._differentiable("classify_loss")
        logits = self.classify(params, batch).float()
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return -torch.mean(torch.gather(F.log_softmax(logits, -1), -1,
                                        labels.long()[:, None]))

    # -- serving ---------------------------------------------------------------
    def init_caches(self, batch, cache_len, dtype=torch.float32,
                    window=None):
        if self.is_encdec:
            return ed.encdec_init_caches(
                self.cfg, batch, min(cache_len, window or cache_len), dtype,
                self.device)
        return bb.init_caches(self.cfg, batch, cache_len, dtype,
                              window=window, device=self.device)

    def prefill(self, params, batch, *, cache_len, window=None,
                dtype=torch.float32):
        """Process the prompt; returns (last_token_logits, caches)."""
        tokens = self._tokens(batch)
        B = tokens.shape[0]
        caches = self.init_caches(B, cache_len, dtype, window=window)
        if self.is_encdec:
            enc_h, _ = self._encode(params, batch)
            h, caches = ed.decode_tokens(params, tokens, enc_h, self.cfg,
                                         mode="prefill", caches=caches,
                                         window=window,
                                         attn_impl=self.attn_impl)
            return self._encdec_logits(params, h[:, -1:])[:, 0], caches
        h = bb.embed_tokens(params, tokens, self.cfg)
        h, caches, _, _ = bb.forward_hidden(
            params, h, self.cfg, mode="prefill", caches=caches,
            window=window, attn_impl=self.attn_impl, **self._mesh_kw())
        logits = bb.logits_from_hidden(params, h[:, -1:], self.cfg)
        return logits[:, 0], caches

    def decode_step(self, params, tokens, caches, pos, *, window=None):
        """tokens: (B,1); ``pos``: the absolute position (an int or a 0-d
        tensor). Returns (logits (B,V), new_caches)."""
        tokens = torch.as_tensor(tokens, device=self.device)
        if self.is_encdec:
            h, caches = ed.decode_tokens(params, tokens, None, self.cfg,
                                         mode="decode", caches=caches,
                                         pos=pos, window=window)
            return self._encdec_logits(params, h)[:, 0], caches
        h = bb.embed_tokens(params, tokens, self.cfg)
        h, caches, _, _ = bb.forward_hidden(
            params, h, self.cfg, mode="decode", caches=caches, pos=pos,
            window=window, attn_impl=self.attn_impl, **self._mesh_kw())
        logits = bb.logits_from_hidden(params, h, self.cfg)
        return logits[:, 0], caches


def build_model(cfg, *, device=None, mesh=None, attn_impl="plain",
                remat=False) -> Model:
    return Model(cfg, device=device, mesh=mesh, attn_impl=attn_impl,
                 remat=remat)
