"""Flat-npz checkpointing for nested dicts of tensors (the reference's
``train/checkpoint.py``).

Leaves are flattened to ``params|path|like|this`` (and ``opt|...``)
keys, a ``None`` leaf is stored as ``...|__none__`` and the metadata
(step, config name) rides along as JSON in ``__meta__``: the reference's
layout, so a file written by either package loads in the other with
equal arrays and meta.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "|"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0)
    elif isinstance(tree, torch.Tensor):
        out[prefix.rstrip(_SEP)] = tree.detach().cpu().numpy()
    else:
        out[prefix.rstrip(_SEP)] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        if parts[-1] == "__none__":
            parts = parts[:-1]
            val = None
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree)).to(device)


def save_checkpoint(path: str, params, opt_state=None, *, step: int = 0,
                    meta: dict = None):
    """Write ``params`` (and ``opt_state``) — nested dicts of tensors or
    arrays — to ``path`` (``np.savez`` appends ``.npz`` when missing)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"params{_SEP}{k}": v for k, v in _flatten(params).items()}
    if opt_state is not None:
        flat.update({f"opt{_SEP}{k}": v
                     for k, v in _flatten(opt_state).items()})
    flat["__meta__"] = np.frombuffer(
        json.dumps({"step": step, **(meta or {})}).encode(), np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str, *, device=None) -> Tuple[Any, Any, dict]:
    """Read a checkpoint of either package: (params, opt_state or None,
    meta), the tensors on ``device`` (the card unless ``device="cpu"``).
    """
    device = resolve_device(device)
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        pflat, oflat = {}, {}
        for k in z.files:
            if k == "__meta__":
                continue
            scope, rest = k.split(_SEP, 1)
            (pflat if scope == "params" else oflat)[rest] = z[k]
    params = _to_device(_unflatten(pflat), device)
    opt = _to_device(_unflatten(oflat), device) if oflat else None
    return params, opt, meta
