"""Nested-dict checkpointing: one ``.npz`` shard per top-level key plus a
JSON manifest holding the tree structure.

The same format as the reference package's ``ckpt/store.py``, so a
checkpoint written by either loads in the other.  Leaves are keyed by
their ``/``-joined path of dict keys; the reference takes that path from
JAX's tree flattening, which on dicts of arrays is the same walk over
sorted keys.  Leaves may be numpy arrays or torch tensors (saved from
the host); loading gives numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        if isinstance(tree, torch.Tensor):
            return {prefix: tree.detach().cpu().numpy()}
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    return None


def save_checkpoint(directory: str, state: Dict[str, Any],
                    step: int = 0) -> None:
    """``state`` maps shard name (e.g. "params", "opt") -> nested dict."""
    os.makedirs(directory, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "shards": {}}
    for name, tree in state.items():
        flat = _flatten(tree)
        np.savez(os.path.join(directory, f"{name}.npz"), **flat)
        manifest["shards"][name] = {"treedef": _skeleton(tree),
                                    "keys": sorted(flat)}
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def load_checkpoint(directory: str) -> Dict[str, Any]:
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {"step": manifest["step"]}
    for name, meta in manifest["shards"].items():
        with np.load(os.path.join(directory, f"{name}.npz")) as z:
            flat = {k: z[k] for k in z.files}
        out[name] = _unflatten(meta["treedef"], flat)
    return out


def _unflatten(skel: Any, flat: Dict[str, np.ndarray],
               prefix: str = "") -> Any:
    if skel is None:
        return flat[prefix]
    return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in skel.items()}
