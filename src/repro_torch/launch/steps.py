"""Steps of the LM trainer and of generation on one device: the Chicle-
weighted SGD/AdamW step (with gradient accumulation), true local SGD, and
the prefill and flat-cache decode (serve) steps; the decode geometry of
each input shape, and the meta-tensor stand-ins and specs of every step's
arguments that the planner (`launch/dryrun.py`) traces.

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

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import (MAX_FULL_ATTENTION_SEQ, ModelConfig,
                            ShapeConfig, TrainConfig)
from ..models import model as M
from ..models.layers import torch_dtype
from ..obs import PROGRAM_TRACER
from ..optim import optimizers as opt
from ..sharding import AxisRules, Spec, canonical

Tree = Dict[str, torch.Tensor]


def decode_geometry(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Cache length / window / ring flag for a decode shape.

    A shape longer than MAX_FULL_ATTENTION_SEQ (long_500k) requires
    sub-quadratic attention: SSM/hybrid state is O(1); attention layers
    fall back to the arch's sliding window, or the `swa-variant` window for
    full-attention archs."""
    window = cfg.sliding_window
    cache_len = shape.seq_len
    ring = False
    variant = "native"
    if shape.seq_len > MAX_FULL_ATTENTION_SEQ:
        if not window and not cfg.is_attention_free():
            window = cfg.long_context_window
            if cfg.family != "hybrid":
                variant = "swa-variant"
        if window:
            cache_len = min(cache_len, window)
            ring = True
        if cfg.is_attention_free():
            cache_len = 1  # no kv cache at all; k_pos degenerates
    return {"window": window, "cache_len": cache_len, "ring": ring,
            "variant": variant}


def memory_len(cfg: ModelConfig) -> int:
    """Length of the second input stream: audio frames, vlm patches."""
    if cfg.family == "audio":
        return cfg.encoder_seq
    if cfg.family == "vlm":
        return cfg.num_image_tokens
    return 0


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device`; a
    ``train.to_device`` span of `obs.PROGRAM_TRACER` with the batch's
    ``bytes``."""
    with PROGRAM_TRACER.span("train.to_device",
                             bytes=sum(v.nbytes for v in batch.values())):
        return {k: (torch.from_numpy(np.ascontiguousarray(v))
                    if isinstance(v, np.ndarray) else v).to(device)
                for k, v in batch.items()}


def value_and_grad(cfg: ModelConfig, params: M.Transformer,
                   batch: Dict[str, torch.Tensor], *, remat: bool,
                   total_weight: Optional[torch.Tensor] = None, **span_args
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tree]:
    """(loss + aux, metrics, grads by path) of `M.loss_fn`, the gradient
    in each parameter's dtype (`jax.value_and_grad(..., has_aux=True)`).
    `obs.PROGRAM_TRACER` times the two halves on the card:
    ``train.forward`` and ``train.backward`` (remat's recomputation
    included), with `span_args`."""
    leaves = M.param_dict(params)
    params.requires_grad_(True)
    dev, trc = batch["tokens"].device, PROGRAM_TRACER
    with torch.enable_grad():
        with trc.device_span("train.forward", device=dev, **span_args):
            total, metrics = M.loss_fn(cfg, params, batch, remat=remat,
                                       total_weight=total_weight)
        with trc.device_span("train.backward", device=dev, **span_args):
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
    metrics {"loss", "aux_loss", "grad_norm"} (fp32 tensors).

    Each step is timed on the card by `obs.PROGRAM_TRACER`:
    ``train.forward``, ``train.backward`` and one ``train.optimizer`` (the
    update, its assignment and the grad norm); with
    accumulation a forward and a backward per micro-batch and a
    ``train.optimizer`` for each micro-batch's add into the momentum (arg
    ``micro``), besides the step's own."""
    trc = PROGRAM_TRACER

    def _apply(grads, leaves, opt_state):
        if tc.optimizer == "adamw":
            return opt.adamw(grads, opt_state, lr=tc.learning_rate,
                             weight_decay=tc.weight_decay, params=leaves)
        return opt.sgdm(grads, opt_state, lr=tc.learning_rate,
                        momentum=tc.momentum, weight_decay=tc.weight_decay,
                        params=leaves)

    def train_step(params, opt_state, batch):
        leaves = M.param_dict(params)
        dev = batch["tokens"].device
        if tc.accum_steps <= 1:
            _, metrics, grads = value_and_grad(cfg, params, batch,
                                               remat=tc.remat)
            with trc.device_span("train.optimizer", device=dev), \
                    torch.no_grad():
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
                                           total_weight=total_w, micro=a)
            with trc.device_span("train.optimizer", device=dev, micro=a), \
                    torch.no_grad():
                mu = {k: mu[k] + g[k].float() for k in mu}
            loss = loss + metrics["loss"]
            aux = aux + metrics["aux_loss"]
        with trc.device_span("train.optimizer", device=dev), \
                torch.no_grad():
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


# ---------------------------------------------------------------------------
# Meta-tensor stand-ins + specs of every step's arguments
# ---------------------------------------------------------------------------


def _batch_spec(rules: AxisRules, B: int) -> Spec:
    ax = rules.batch
    if ax is None:
        return ()
    if B % rules.axis_size(ax):
        return ()  # undivisible tiny batches (long_500k B=1): replicate
    return (canonical(ax),)


def by_path(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict flattened to {"blocks/attn/wq": leaf}, the keys of
    `models.model.param_dict` and of the optimizer state."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(by_path(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules: AxisRules,
                tc: Optional[TrainConfig] = None) -> Dict[str, Any]:
    """Meta-tensor stand-ins and specs for every argument of a step.

    Returns a dict with keys:
      kind: train|prefill|decode
      args: the step's arguments in order, every tensor on the meta device
        (train: the parameter module, its optimizer state keyed by path,
        the batch; prefill: module, batch; decode: module, cache, token,
        pos)
      in_specs: a spec tree per argument (the parameters' by param_defs'
        keys, the optimizer's by path, the cache's guarded against its
        shapes)
      train_cfg (train); window, variant (prefill, decode); ring (decode).
    The reference's donate_argnums has no counterpart: the port's steps
    update the parameters and caches in place."""
    dt = torch_dtype(cfg)
    B, S = shape.global_batch, shape.seq_len
    bspec = _batch_spec(rules, B)
    params = M.Transformer(cfg, M.param_sds(cfg))
    p_specs = M.param_specs(cfg, rules)
    mem_len = memory_len(cfg)

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        batch_specs: Dict[str, Spec] = {"tokens": (*bspec, None)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
            batch["weights"] = _meta((B,), torch.float32)
            batch_specs["labels"] = (*bspec, None)
            batch_specs["weights"] = (*bspec,)
        if mem_len:
            batch["memory"] = _meta((B, mem_len, cfg.d_model), dt)
            batch_specs["memory"] = (*bspec, None, None)
        if shape.kind == "train":
            tc = tc or TrainConfig()
            o_sds = opt.opt_state_sds(M.param_dict(params),
                                      optimizer=tc.optimizer)
            o_specs = opt.opt_specs(by_path(p_specs), optimizer=tc.optimizer)
            return {"kind": "train", "args": (params, o_sds, batch),
                    "in_specs": (p_specs, o_specs, batch_specs),
                    "train_cfg": tc}
        geo = decode_geometry(cfg, shape)
        return {"kind": "prefill", "args": (params, batch),
                "in_specs": (p_specs, batch_specs),
                "window": geo["window"] or None, "variant": "native"}

    geo = decode_geometry(cfg, shape)
    cache = M.cache_sds(cfg, B, geo["cache_len"], cross_len=mem_len)
    c_specs = M.cache_specs(cfg, rules)
    # drop any cache-dim sharding whose size is not divisible by the mesh
    # axis (tiny batches, 1500-frame cross caches, ring windows, ...)
    c_specs["blocks"] = {k: rules.guard(v, tuple(cache["blocks"][k].shape))
                         for k, v in c_specs["blocks"].items()}
    if "k_pos" in c_specs:
        c_specs["k_pos"] = rules.guard(c_specs["k_pos"],
                                       tuple(cache["k_pos"].shape))
    return {"kind": "decode",
            "args": (params, cache, _meta((B, 1), torch.int32),
                     _meta((), torch.int32)),
            "in_specs": (p_specs, c_specs, (*bspec, None), ()),
            "window": geo["window"] or None, "ring": geo["ring"],
            "variant": geo["variant"]}


def build_step(cfg: ModelConfig, spec: Dict[str, Any]):
    """The step `input_specs`' args feed: the train step, the prefill step
    or the flat-cache serve step (`decode_step`; no paged kernel lies on
    this path)."""
    if spec["kind"] == "train":
        return make_train_step(cfg, spec["train_cfg"])
    if spec["kind"] == "prefill":
        return make_prefill_step(cfg, window=spec.get("window"))
    return make_serve_step(cfg, window=spec.get("window"),
                           ring=spec.get("ring", False))
