"""Steps of the LM trainer and of generation on one device: the Chicle-
weighted SGD/AdamW step (with gradient accumulation), true local SGD, and
the prefill and flat-cache decode (serve) steps.

Train batches carry a per-example `weights` vector assembled by
`data.ChunkBatchPipeline` from the chunk->worker table; the weighted-mean
loss makes the gradient equal the paper's |D_k|/|D^|-weighted merge
without touching the step when workers scale in/out or chunks move.

The JAX package returns new parameter trees; these steps update the
parameter module's leaves in place (one copy of the weights, not two) and
return the same module.  Optimizer trees are flat dicts keyed by pytree
path (`models.model.param_dict`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models import model as M
from ..optim import optimizers as opt

Tree = Dict[str, torch.Tensor]


def memory_len(cfg: ModelConfig) -> int:
    """Length of the second input stream: audio frames, vlm patches."""
    if cfg.family == "audio":
        return cfg.encoder_seq
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return 0


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v))
                if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig, params: M.Transformer,
                   batch: Dict[str, torch.Tensor], *, remat: bool,
                   total_weight: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tree]:
    """(loss + aux, metrics, grads by path) of `M.loss_fn`, the gradient
    in each parameter's dtype (`jax.value_and_grad(..., has_aux=True)`)."""
    leaves = M.param_dict(params)
    params.requires_grad_(True)
    with torch.enable_grad():
        total, metrics = M.loss_fn(cfg, params, batch, remat=remat,
                                   total_weight=total_weight)
        grads = torch.autograd.grad(total, list(leaves.values()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, dict(zip(leaves, grads))


def _tree_gn(g: Tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum()
                          for x in opt.tree_leaves(g)))


@torch.no_grad()
def _assign(params: M.Transformer, new: Tree) -> None:
    for name, p in M.param_dict(params).items():
        p.copy_(new[name])


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics) with
    metrics {"loss", "aux_loss", "grad_norm"} (fp32 tensors)."""

    def _apply(grads, leaves, opt_state):
        if tc.optimizer == "adamw":
            return opt.adamw(grads, opt_state, lr=tc.learning_rate,
                             weight_decay=tc.weight_decay, params=leaves)
        return opt.sgdm(grads, opt_state, lr=tc.learning_rate,
                        momentum=tc.momentum, weight_decay=tc.weight_decay,
                        params=leaves)

    def train_step(params, opt_state, batch):
        leaves = M.param_dict(params)
        if tc.accum_steps <= 1:
            _, metrics, grads = value_and_grad(cfg, params, batch,
                                               remat=tc.remat)
            with torch.no_grad():
                updates, opt_state2 = _apply(grads, leaves, opt_state)
                _assign(params, opt.apply_updates(leaves, updates))
                metrics = dict(metrics, grad_norm=_tree_gn(grads))
            return params, opt_state2, metrics

        # gradient accumulation: microbatch grads accumulate straight into
        # the fp32 momentum buffer — no extra grad buffer
        A = tc.accum_steps
        if tc.optimizer != "sgdm":
            raise ValueError("accum_steps>1 requires sgdm")
        total_w = batch["weights"].float().sum().clamp_min(1e-9)
        mu0 = {k: tc.momentum * m for k, m in opt_state.mu.items()}
        mu = dict(mu0)
        loss = aux = torch.zeros((), device=total_w.device)
        n = batch["tokens"].shape[0] // A
        for a in range(A):
            micro = {k: v[a * n:(a + 1) * n] for k, v in batch.items()}
            _, metrics, g = value_and_grad(cfg, params, micro,
                                           remat=tc.remat,
                                           total_weight=total_w)
            with torch.no_grad():
                mu = {k: mu[k] + g[k].float() for k in mu}
            loss = loss + metrics["loss"]
            aux = aux + metrics["aux_loss"]
        with torch.no_grad():
            g_total = {k: mu[k] - mu0[k] for k in mu}
            updates = {k: -tc.learning_rate * m for k, m in mu.items()}
            _assign(params, opt.apply_updates(leaves, updates))
            metrics = {"loss": loss, "aux_loss": aux,
                       "grad_norm": _tree_gn(g_total)}
        return params, opt.OptState(opt_state.step + 1, mu, None), metrics

    return train_step


def make_lsgd_train_step(cfg: ModelConfig, tc: TrainConfig):
    """True local SGD (Lin et al. 2018; the paper's DNN algorithm) on one
    device (one data shard): a replica runs H local SGD steps of L samples
    each, its delta is Stich-weighted by its share of the batch weight (all
    of it, with one shard), and the momentum merge moves the parameters.

    (params, momentum, batch) -> (params, momentum, {"loss"}); batch:
    tokens/labels (B, S) with B = H * L, weights (B,); momentum: fp32 tree
    by path."""
    H = tc.local_steps

    def train_step(params, momentum, batch):
        L = batch["tokens"].shape[0] // H
        replica = M.params_from_paths(cfg, {
            k: a.detach().clone() for k, a in M.param_dict(params).items()})
        losses = []
        for h in range(H):
            micro = {k: v[h * L:(h + 1) * L] for k, v in batch.items()}
            loss, _, g = value_and_grad(cfg, replica, micro, remat=tc.remat)
            with torch.no_grad():
                _assign(replica, {k: (a - tc.learning_rate * g[k]).to(a.dtype)
                                  for k, a in M.param_dict(replica).items()})
            losses.append(loss)
        with torch.no_grad():
            leaves, ends = M.param_dict(params), M.param_dict(replica)
            delta = {k: (ends[k] - a).float() for k, a in leaves.items()}
            my_w = batch["weights"].sum()
            frac = my_w / my_w.clamp_min(1e-9)  # one shard: total == mine
            new_mom = {k: tc.momentum * momentum[k] + d * frac
                       for k, d in delta.items()}
            _assign(params, {k: (a.float() + new_mom[k]).to(a.dtype)
                             for k, a in leaves.items()})
        return params, new_mom, {"loss": torch.stack(losses).mean()}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, window: Optional[int] = None):
    """(params, batch) -> (last-token logits, cache) of `M.prefill` over
    batch["tokens"] (and batch["memory"] for vlm/audio)."""
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch["tokens"],
                         memory=batch.get("memory"), window=window)
    return prefill_step


def make_serve_step(cfg: ModelConfig, *, window: Optional[int] = None,
                    ring: bool = False):
    """(params, cache, token, pos) -> (logits, cache) of one flat-cache
    `M.decode_step` (the cache updated in place)."""
    def serve_step(params, cache, token, pos):
        return M.decode_step(cfg, params, cache, token, pos, window=window,
                             ring=ring)
    return serve_step
