"""Synthetic template-grammar corpus (DESIGN.md §8, data note).

GLUE/SST-2 and WikiText are unavailable offline; this generator reproduces
the *property AttMemo exploits*: inputs sharing clause structure ("I like
apple." / "I like banana.") produce similar attention probability matrices.
Each sample instantiates a template — a fixed token skeleton with variable
slots — so cross-input APM similarity is controlled by ``slot_fraction``
(the knob the paper's natural corpora fix implicitly; we can sweep it).

Tasks:
* classification — label = template family (the accuracy experiments);
* language modelling — batched next-token streams for the trainer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass
class TemplateCorpus:
    vocab: int
    seq_len: int
    n_templates: int = 8
    slot_fraction: float = 0.25      # fraction of positions that vary
    n_classes: int = 4
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # reserve the low vocab range for skeleton tokens, high for slots
        skel_hi = max(2, int(self.vocab * 0.6))
        self._skeletons = rng.integers(
            1, skel_hi, (self.n_templates, self.seq_len))
        n_slots = max(1, int(self.seq_len * self.slot_fraction))
        self._slot_pos = np.stack([
            rng.choice(self.seq_len, n_slots, replace=False)
            for _ in range(self.n_templates)])
        self._slot_lo = skel_hi
        self._rng = rng

    def sample(self, n: int, rng=None) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens (n, seq_len) int32, labels (n,) int32)."""
        rng = rng or self._rng
        t_ids = rng.integers(0, self.n_templates, n)
        toks = self._skeletons[t_ids].copy()
        fills = rng.integers(self._slot_lo, self.vocab,
                             (n, self._slot_pos.shape[1]))
        rows = np.arange(n)[:, None]
        toks[rows, self._slot_pos[t_ids]] = fills
        labels = (t_ids % self.n_classes).astype(np.int32)
        return toks.astype(np.int32), labels

    def batches(self, n_batches: int, batch_size: int,
                rng=None) -> Iterator[dict]:
        rng = rng or self._rng
        for _ in range(n_batches):
            toks, labels = self.sample(batch_size, rng)
            yield {"tokens": toks, "labels": labels}


def lm_batches(vocab: int, seq_len: int, batch_size: int, n_batches: int,
               *, seed: int = 0, corpus: TemplateCorpus = None
               ) -> Iterator[dict]:
    """Next-token LM batches. With a TemplateCorpus the stream is learnable
    (skeletons are deterministic given the prefix); otherwise a Zipfian
    stream with a k-order Markov backbone is used so perplexity can drop."""
    rng = np.random.default_rng(seed)
    if corpus is not None:
        for _ in range(n_batches):
            toks, _ = corpus.sample(batch_size, rng)
            yield {"tokens": toks}
        return
    # Markov backbone: token_t = f(token_{t-1}) with noise
    table = rng.integers(0, vocab, vocab)
    for _ in range(n_batches):
        toks = np.zeros((batch_size, seq_len), np.int64)
        toks[:, 0] = rng.integers(0, vocab, batch_size)
        for t in range(1, seq_len):
            follow = table[toks[:, t - 1]]
            noise = rng.integers(0, vocab, batch_size)
            use_noise = rng.random(batch_size) < 0.15
            toks[:, t] = np.where(use_noise, noise, follow)
        yield {"tokens": toks.astype(np.int32)}
