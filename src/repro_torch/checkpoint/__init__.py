"""Flat-npz tree checkpointing with a JSON sidecar: the JAX package's
schema (``repro/checkpoint/__init__.py``), read and written with torch.

``save(path, tree, meta)`` / ``restore(path)`` round-trip a nested dict of
tensors; the structure is recorded as '/'-joined key paths.  npz cannot hold
bfloat16, so such leaves are stored as a same-width integer view and the
true dtype goes into the sidecar's ``_dtypes``.  ``restore`` returns CPU
tensors and turns those views back into ``torch.bfloat16`` through a
same-width view, without ``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict (lists allowed) -> {'a/b/c': leaf}."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for key, sub in items:
        flat.update(flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _restore_lists(tree)


def _restore_lists(node):
    """npz keys lose list-ness: dicts keyed 0..n-1 become lists again."""
    if not isinstance(node, dict):
        return node
    node = {k: _restore_lists(v) for k, v in node.items()}
    keys = list(node)
    if keys and all(k.isdigit() for k in keys):
        order = sorted(keys, key=int)
        if [int(k) for k in order] == list(range(len(order))):
            return [node[k] for k in order]
    return node


def _paths(path: str) -> Tuple[str, str]:
    stem = path[:-4] if path.endswith(".npz") else path
    return stem + ".npz", stem + ".json"


def save(path: str, tree, meta: Optional[dict] = None) -> None:
    npz_path, meta_path = _paths(path)
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    dtypes, store = {}, {}
    for k, v in flatten(tree).items():
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:      # stored as its uint16 bits
                dtypes[k] = "bfloat16"
                v = t.view(torch.int16).numpy().view(np.uint16)
            else:
                v = t.numpy()
        store[k] = np.asarray(v)
    np.savez(npz_path, **store)
    with open(meta_path, "w") as f:
        json.dump({"meta": meta or {}, "_dtypes": dtypes}, f, indent=2,
                  default=str)


def restore(path: str) -> Tuple[Any, dict]:
    """Returns (tree of CPU tensors, meta)."""
    npz_path, meta_path = _paths(path)
    with np.load(npz_path) as data:
        flat = {k: data[k] for k in data.files}
    meta, dtypes = {}, {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            doc = json.load(f)
        meta, dtypes = doc.get("meta", {}), doc.get("_dtypes", {})
    out = {}
    for k, arr in flat.items():
        if k in dtypes:
            if dtypes[k] != "bfloat16" or arr.dtype.itemsize != 2:
                raise ValueError(f"checkpoint leaf {k!r} has dtype "
                                 f"{dtypes[k]!r}, which the port cannot read")
            out[k] = torch.from_numpy(
                arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            # ascontiguousarray alone would turn a 0-d leaf into (1,)
            out[k] = torch.from_numpy(
                np.ascontiguousarray(arr).reshape(arr.shape))
    return unflatten(out), meta
