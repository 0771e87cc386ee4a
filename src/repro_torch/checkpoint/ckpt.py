"""Elasticity-aware npz checkpointing.

Saves the model/optimizer trees AND the Chicle scheduling state — the
chunk->worker assignment and per-sample chunk state (e.g. CoCoA alphas) —
so a restore resumes with the exact same data placement.  The flat key
encoding is the JAX package's (`checkpoint/ckpt.py`): tree paths joined
with '/', under `params/`, `opt/` (`step`, `mu/...`, `nu/...`) and
`chunk_state/`, so a checkpoint written by either package loads into the
other leaf for leaf.  numpy has no bfloat16, so bf16 leaves are stored as
float32 (exactly) and cast back on load.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.model import Transformer, param_dict, params_from_paths
from ..optim.optimizers import OptState


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Leaves by '/'-joined path: a parameter module by its pytree paths,
    an OptState by field (a None field has no leaves), dicts by key."""
    if isinstance(tree, nn.Module):
        tree = param_dict(tree)
    if isinstance(tree, OptState):
        tree = {f: v for f, v in zip(tree._fields, tree) if v is not None}
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def save_checkpoint(path: str, step: int, params: Any,
                    opt_state: Any = None, *, extra: Optional[Dict] = None,
                    assignment=None, chunk_state: Optional[Dict] = None
                    ) -> str:
    os.makedirs(path, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _flatten(params, "params/").items()}
    if opt_state is not None:
        arrays.update({k: _to_numpy(v)
                       for k, v in _flatten(opt_state, "opt/").items()})
    if chunk_state:
        arrays.update({f"chunk_state/{k}": np.asarray(v)
                       for k, v in chunk_state.items()})
    meta = {"step": step, "extra": extra or {}}
    if assignment is not None:
        meta["assignment"] = [list(map(int, w)) for w in assignment.workers]
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    np.savez(fn, **arrays)
    with open(os.path.join(path, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return fn


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz", f))]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: int, params_like: Any,
                    opt_like: Any = None) -> Tuple[Any, Any, Dict]:
    """Restore trees shaped like the templates, each leaf on its template
    leaf's device and in its dtype: a parameter module comes back as a new
    module, an OptState as an OptState, dicts as dicts."""
    fn = os.path.join(path, f"ckpt_{step:08d}.npz")
    data = np.load(fn)
    with open(os.path.join(path, f"ckpt_{step:08d}.json")) as f:
        meta = json.load(f)

    def leaf(key, like):
        arr = data[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} in the "
                             f"checkpoint, {tuple(like.shape)} expected")
        if isinstance(like, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
        return arr.astype(like.dtype)

    def restore(tree, prefix):
        if isinstance(tree, Transformer):
            return params_from_paths(tree.cfg, {
                k: leaf(f"{prefix}{k}", v)
                for k, v in param_dict(tree).items()})
        if isinstance(tree, OptState):
            return OptState(*(None if v is None
                              else restore(v, f"{prefix}{f}/")
                              for f, v in zip(tree._fields, tree)))
        if isinstance(tree, dict):
            return {k: restore(v, f"{prefix}{k}/") for k, v in tree.items()}
        return leaf(prefix[:-1], tree)

    params = restore(params_like, "params/")
    opt = restore(opt_like, "opt/") if opt_like is not None else None
    meta["chunk_state"] = {k.split("/", 1)[1]: data[k]
                           for k in data.files if k.startswith("chunk_state/")}
    return params, opt, meta
