"""Top-level model API for every family: parameters, full-sequence
forward, the Chicle-weighted LM loss, prefill and the flat-cache decode
step; for the dense and moe families also the flat-cache verify step and
the paged-KV decode / verify / chunked-prefill steps.

The parameters live in a `Transformer` module whose attribute tree is the
JAX package's parameter pytree (same keys, blocks stacked along a leading
layer dim, Q heads padded as in JAX), so `params_from_numpy` carries a JAX
tree across one to one.  The JAX package's `lax.scan` over blocks is a loop
over layers here, and its `jax.checkpoint` of the block body is
`torch.utils.checkpoint` per block.  Paged KV pools are plain tensors that
the steps update in place; so are the flat per-slot caches, their `k_pos`
and the recurrent states (mamba conv/h, rwkv shift/wkv).

vlm and audio take a second input stream, `memory`: (B, T, D) stub patch
embeddings (vlm) or frame embeddings (audio, through the bidirectional
encoder first), cross-attended by the decoder.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from . import transformer as tfm
from .layers import (ParamDef, cross_entropy, init_tree, map_defs, rms_norm,
                     sds_tree, spec_tree, torch_dtype)

AUX_LOSS_COEF = 0.01


def _ln_def(cfg: ModelConfig) -> ParamDef:
    return ParamDef((cfg.d_model,), (None,), init="ones")


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("tensor", "fsdp"),
                          init="small"),
        "final_ln": _ln_def(cfg),
    }
    if cfg.family == "audio":
        defs["blocks"] = map_defs(lambda d: d.stacked(cfg.num_layers),
                                  tfm.block_defs(cfg, "xdec"))
        enc = map_defs(lambda d: d.stacked(cfg.encoder_layers),
                       tfm.block_defs(cfg, "dense"))
        defs["encoder"] = {"blocks": enc, "final_ln": _ln_def(cfg)}
    else:
        nb = tfm.n_blocks(cfg)
        defs["blocks"] = map_defs(lambda d: d.stacked(nb),
                                  tfm.block_defs(cfg))
    return defs


def param_specs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """The parameters' spec tree under `rules` (`sharding.AxisRules`)."""
    return spec_tree(param_defs(cfg), rules)


def param_sds(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree as meta tensors (shapes and dtypes, no
    storage); `Transformer(cfg, param_sds(cfg))` is a module over them."""
    return sds_tree(param_defs(cfg), torch_dtype(cfg))


def count_params(cfg: ModelConfig) -> int:
    sizes = []
    map_defs(lambda d: sizes.append(int(np.prod(d.shape))), param_defs(cfg))
    return sum(sizes)


def _block_type(cfg: ModelConfig) -> str:
    if cfg.family not in tfm.FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    return "xdec" if cfg.family == "audio" else cfg.family


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict keys become attribute
    names, leaves parameters.  They start frozen; the training steps turn
    on their gradients and update them in place."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v,
                                                        requires_grad=False))

    def layer(self, index: int) -> Dict[str, Any]:
        """Layer `index` of every stacked leaf, as nested dicts of views."""
        out: Dict[str, Any] = {k: p[index]
                               for k, p in self._parameters.items()}
        out.update({k: m.layer(index) for k, m in self._modules.items()})
        return out


class Transformer(ParamTree):
    """The model's parameters: `embed`, `final_ln` and `blocks` (each leaf
    stacked (n_blocks, ...); a moe block's experts (n_blocks, E, ...));
    audio also `encoder` {`blocks` (encoder_layers, ...), `final_ln`}."""

    def __init__(self, cfg: ModelConfig, tree: Dict[str, Any]):
        super().__init__(tree)
        self.cfg = cfg
        self._views: Dict[str, list] = {}

    def _apply(self, fn, recurse=True):
        self._views = {}  # per-layer views would point at the old storage
        return super()._apply(fn, recurse)

    def _layer_views(self, name: str, stack: ParamTree, n: int):
        """Per-layer parameter dicts (views into the stacked leaves).  The
        views are cached for inference; while the leaves take gradients
        they are made anew, so autograd sees each one."""
        if self.embed.requires_grad and torch.is_grad_enabled():
            return [stack.layer(i) for i in range(n)]
        if name not in self._views:
            self._views[name] = [stack.layer(i) for i in range(n)]
        return self._views[name]

    def layers(self):
        """The (decoder) blocks' per-layer parameter dicts."""
        return self._layer_views("blocks", self.blocks,
                                 tfm.n_blocks(self.cfg))

    def encoder_layers(self):
        """The audio encoder's per-layer parameter dicts."""
        return self._layer_views("encoder", self.encoder.blocks,
                                 self.cfg.encoder_layers)


def param_dict(params: nn.Module) -> Dict[str, torch.Tensor]:
    """The leaves of a parameter module by their pytree path
    ("blocks/attn/wq"), the keys of the JAX package's flat encoding."""
    return {n.replace(".", "/"): p for n, p in params.named_parameters()}


def _check_tree(defs: Any, tree: Any, path: str = "") -> None:
    if isinstance(defs, ParamDef):
        if tuple(tree.shape) != defs.shape:
            raise ValueError(f"param {path}: shape {tuple(tree.shape)}, "
                             f"expected {defs.shape}")
        return
    if not isinstance(tree, dict) or set(tree) != set(defs):
        got = sorted(tree) if isinstance(tree, dict) else type(tree)
        raise ValueError(f"param tree at {path or '/'}: keys {got}, "
                         f"expected {sorted(defs)}")
    for k in defs:
        _check_tree(defs[k], tree[k], f"{path}/{k}")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Transformer:
    """Random parameters from `generator` (which must live on `device`)."""
    tree = init_tree(param_defs(cfg), generator, torch_dtype(cfg),
                     torch.device(device))
    return Transformer(cfg, tree)


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> Transformer:
    """The JAX parameter pytree as nested dicts of numpy arrays (same keys,
    stacked (nb, ...) layout, padded heads) -> the port's module."""
    defs = param_defs(cfg)
    _check_tree(defs, tree)
    dt = torch_dtype(cfg)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        # float32 first: numpy has no bfloat16 that torch can read
        arr = np.array(node, dtype=np.float32)  # a writable copy
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    return Transformer(cfg, conv(tree))


def params_from_paths(cfg: ModelConfig,
                      flat: Dict[str, torch.Tensor]) -> Transformer:
    """The inverse of `param_dict`: a module whose leaves are the given
    tensors (shared, not copied), keyed by pytree path."""
    tree: Dict[str, Any] = {}
    for path, t in flat.items():
        *head, leaf = path.split("/")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = t
    _check_tree(param_defs(cfg), tree)
    return Transformer(cfg, tree)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _logits(params: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Tied output head: final norm, then the embedding transposed."""
    return rms_norm(x, params.final_ln) @ params.embed.t()


def _block_x(cfg, bp, x, positions, bt, window, memory, q_block):
    x, _, aux = tfm.block_apply(cfg, bp, x, positions, block_type=bt,
                                window=window, memory=memory,
                                q_block=q_block)
    return x, aux


def _encoder_block(cfg, bp, x):
    return tfm.block_apply(cfg, bp, x, None, block_type="dense",
                           causal=False)[0]


def _encoder_forward(cfg: ModelConfig, params: Transformer,
                     frames: torch.Tensor, remat: bool) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings (B, T, D):
    bidirectional, no rope."""
    x = frames
    for bp in params.encoder_layers():
        if remat:
            x = checkpoint(_encoder_block, cfg, bp, x, use_reentrant=False)
        else:
            x = _encoder_block(cfg, bp, x)
    return rms_norm(x, params.encoder.final_ln)


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None,
            window: Optional[int] = None, return_cache: bool = False,
            return_aux: bool = False, q_block: int = 512,
            remat: bool = True):
    """Full-sequence causal forward.  tokens: (B, S) int.

    memory: (B, T, D) stub patch embeddings (vlm) or frame embeddings
    (audio: through the encoder first).
    remat: while autograd records, each block's activations are recomputed
    in backward instead of kept (the JAX package's `jax.checkpoint(body)`).

    Returns logits (B, S, V); with return_aux (logits, aux), aux the sum of
    the blocks' moe load-balance losses (0 without moe); with return_cache
    the family's cache after the sequence comes last: each
    `transformer.block_cache_shapes` entry stacked over blocks, k/v rows
    S long (dense/moe/xdec/hybrid: {"k", "v": (nb, B, S, KV, hd)})."""
    B, S = tokens.shape
    bt = _block_type(cfg)
    win = cfg.sliding_window if window is None else window
    x = params.embed[tokens.long()]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    remat = remat and torch.is_grad_enabled() and not return_cache
    if cfg.family == "audio":
        memory = _encoder_forward(cfg, params, memory, remat)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for bp in params.layers():
        if remat:
            x, a = checkpoint(_block_x, cfg, bp, x, positions, bt, win,
                              memory, q_block, use_reentrant=False)
        else:
            x, c, a = tfm.block_apply(
                cfg, bp, x, positions, block_type=bt, window=win,
                cache={} if return_cache else None, memory=memory,
                q_block=q_block)
            if return_cache:
                caches.append(c)
        if a is not None:
            aux = aux + a
    out = (_logits(params, x),)
    if return_aux:
        out += (aux,)
    if return_cache:
        out += ({k: torch.stack([c[k] for c in caches]) for k in caches[0]},)
    return out if len(out) > 1 else out[0]


def loss_fn(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], *, remat: bool = True,
            q_block: int = 512,
            total_weight: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chicle-weighted LM loss.

    batch: tokens (B, S) int, labels (B, S) int, weights (B,) float — the
    per-example weights carry the uni-task chunk weighting |D_k|/|D^|
    (Stich 2018): grad(loss) == the weighted merge of per-worker updates;
    vlm and audio also memory (B, T, D).

    total_weight: the FULL global-batch weight sum when this call sees only
    a microbatch (gradient accumulation), so microbatch grads sum to the
    full-batch gradient.  Returns (loss + AUX_LOSS_COEF * aux, metrics
    {"loss", "aux_loss"}); aux is the moe load-balance loss summed over
    blocks, 0 for the dense model."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          memory=batch.get("memory"), remat=remat,
                          q_block=q_block, return_aux=True)
    ce = cross_entropy(logits, batch["labels"])  # (B, S)
    w = batch["weights"].float()
    per_ex = ce.mean(-1)
    total_w = (w.sum().clamp_min(1e-9) if total_weight is None
               else total_weight)
    loss = (per_ex * w).sum() / total_w
    return loss + AUX_LOSS_COEF * aux, {"loss": loss, "aux_loss": aux}


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None,
            window: Optional[int] = None, q_block: int = 512,
            cache_len: Optional[int] = None,
            true_len: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Forward over the prompt -> (last-token logits (B, 1, V), cache).

    The cache's blocks are `forward`'s cache, its k/v rows zero-padded
    past S up to cache_len (the flat engine passes its cache_len; the
    paged engine the bucket length, and its insert chops the rows into
    pages); the recurrent states and the memory's xk/xv are not padded.
    Without true_len, cache["k_pos"] is one shared (cache_len,) vector
    (arange(S), -1 past it); true_len: optional (B,) real prompt lengths
    of right-padded rows, the logits are then taken at each row's true
    last token and k_pos is per row (B, cache_len), -1 past each row's
    length (as `init_cache(per_slot=True)`).  The ssm family has no k_pos
    (its state has no positions)."""
    logits, rows = forward(cfg, params, tokens, memory=memory,
                           window=window, return_cache=True, q_block=q_block)
    bt = _block_type(cfg)
    S = tokens.shape[1]
    cache_len = cache_len or S
    if cache_len > S and bt != "ssm":
        # the seq axis of (nb, [k-1,] B, S, KV, hd) is third from the end
        pad = (0, 0, 0, 0, 0, cache_len - S)
        rows = {k: torch.nn.functional.pad(v, pad) if k in ("k", "v")
                else v for k, v in rows.items()}
    cache: Dict[str, Any] = {"blocks": rows}
    pos_row = torch.arange(cache_len, dtype=torch.int32,
                           device=tokens.device)
    if true_len is None:
        if bt != "ssm":
            cache["k_pos"] = torch.where(pos_row < S, pos_row, -1)
        return logits[:, -1:], cache
    if bt != "ssm":
        cache["k_pos"] = torch.where(pos_row[None] < true_len[:, None],
                                     pos_row[None], -1)
    last = (true_len.long() - 1)[:, None, None].expand(-1, 1,
                                                       logits.shape[-1])
    return torch.gather(logits, 1, last), cache


# ---------------------------------------------------------------------------
# Flat cache: one (cache_len,) row of K/V per sequence, or its recurrent
# state
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device, *,
               cross_len: int = 0, per_slot: bool = False) -> Dict[str, Any]:
    """Empty flat cache {"blocks": the `transformer.block_cache_shapes`
    entries stacked over blocks (dense/moe: {"k", "v": (nb, B, cache_len,
    KV, hd)}), "k_pos"}.  cross_len: the memory length of vlm/audio (their
    xk/xv).  per_slot: a per-ROW k_pos (B, cache_len) so every sequence
    tracks its own fill depth (continuous-batching slot pools); else one
    shared (cache_len,) vector for lockstep batches.  -1 marks an empty
    position.  The ssm family has no k_pos."""
    bt = _block_type(cfg)
    nb = tfm.n_blocks(cfg)
    shapes = tfm.block_cache_shapes(cfg, B, cache_len, bt,
                                    cross_len=cross_len)
    cache: Dict[str, Any] = {"blocks": {
        k: torch.zeros((nb,) + s, dtype=d, device=device)
        for k, (s, d) in shapes.items()}}
    if bt != "ssm":
        kp_shape = (B, cache_len) if per_slot else (cache_len,)
        cache["k_pos"] = torch.full(kp_shape, -1, dtype=torch.int32,
                                    device=device)
    return cache


def cache_sds(cfg: ModelConfig, B: int, cache_len: int, *,
              cross_len: int = 0) -> Dict[str, Any]:
    """`init_cache`'s lockstep cache as meta tensors (one shared
    (cache_len,) int32 k_pos)."""
    return init_cache(cfg, B, cache_len, "meta", cross_len=cross_len)


def cache_specs(cfg: ModelConfig, rules) -> Dict[str, Any]:
    """Specs of `cache_sds`'s tree under `rules` (unguarded: the caller
    guards them against the cache's shapes)."""
    bt = _block_type(cfg)
    specs: Dict[str, Any] = {"blocks": tfm.cache_specs_for(cfg, rules, bt)}
    if bt != "ssm":
        specs["k_pos"] = (None,)
    return specs


def decode_step(cfg: ModelConfig, params: Transformer, cache,
                token: torch.Tensor, pos, *, window: Optional[int] = None,
                ring: bool = False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One flat-cache decode step.  token: (B, 1) int; pos: a scalar (int
    or 0-d tensor: a lockstep batch) or a (B,) vector of per-row positions
    (slot pools, with the per-row k_pos of `init_cache(per_slot=True)` or
    `prefill(true_len=...)`).  Writes at pos (pos % cache_len with `ring`,
    else clamped to the last row).

    Returns (logits (B, 1, V), cache); the cache's rows, recurrent states
    and k_pos are updated in place."""
    bt = _block_type(cfg)
    win = cfg.sliding_window if window is None else window
    B = token.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    k_rows = None  # the ssm state has no positions
    if bt != "ssm":
        k_pos = cache["k_pos"]
        W = k_pos.shape[-1]
        if k_pos.dim() == 2:  # per-row cache: each row tracks its own depth
            posv = pos if pos.dim() else pos.expand(B)
            idx = posv % W if ring else torch.clamp(posv, max=W - 1)
            k_pos[torch.arange(B, device=k_pos.device), idx.long()] = posv
            k_rows = k_pos
        else:
            if pos.dim():
                raise ValueError(
                    "vector pos requires a per-row k_pos: build the cache "
                    "with init_cache(per_slot=True) or "
                    "prefill(true_len=...)")
            idx = pos % W if ring else torch.clamp(pos, max=W - 1)
            # a 1-element index: a 0-d one would be read on the host
            k_pos.index_copy_(0, idx.long().reshape(1), pos.reshape(1))
            k_rows = k_pos[None]
    x = params.embed[token.long()]
    blocks = cache["blocks"]
    for i, bp in enumerate(params.layers()):
        x = tfm.block_decode(cfg, bp, x, pos, k_rows,
                             {k: v[i] for k, v in blocks.items()},
                             block_type=bt, window=win, ring=ring)
    return _logits(params, x), cache


def verify_step(cfg: ModelConfig, params: Transformer, cache,
                tokens: torch.Tensor, pos: torch.Tensor,
                n_new: torch.Tensor, *, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Flat-layout speculative verification: score a SPAN of Q candidate
    tokens per row in ONE forward instead of Q sequential decodes.

    tokens: (B, Q) int, [current token, draft_1..draft_{Q-1}] per row,
    right-padded; pos: (B,) absolute position of each row's first token;
    n_new: (B,) real tokens in the span (0 = inactive row, nothing
    written).  Needs the per-row k_pos.  Position j's logits are those of
    a sequential `decode_step` at that position: drafts past a mismatch
    are causally invisible to earlier positions, so rollback is "ignore
    the tail" (their k_pos entries stay, later than any query that could
    see them).  Returns (logits (B, Q, V), cache), updated in place.
    dense/moe only."""
    tfm.require_paged_family(cfg, "verify")
    B, Q = tokens.shape
    win = cfg.sliding_window if window is None else window
    k_pos = cache["k_pos"]
    if k_pos.dim() != 2:
        raise ValueError("verify_step needs a per-row k_pos: build the "
                         "cache with init_cache(per_slot=True) or "
                         "prefill(true_len=...)")
    span = torch.arange(Q, dtype=torch.int32, device=tokens.device)
    q_pos = pos.to(torch.int32)[:, None] + span
    valid = span[None] < n_new[:, None]
    tfm.span_scatter(k_pos, q_pos, q_pos, valid)
    x = params.embed[tokens.long()]
    blocks = cache["blocks"]
    for i, bp in enumerate(params.layers()):
        x = tfm.block_verify(cfg, bp, x, q_pos, valid, k_pos,
                             {"k": blocks["k"][i], "v": blocks["v"][i]},
                             window=win)
    return _logits(params, x), cache


# ---------------------------------------------------------------------------
# Paged KV cache (block tables over fixed-size token pages)
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     device) -> Dict[str, Any]:
    """Physical K/V page pools {"blocks": {"k", "v": (nb, n_pages, ps, KV,
    hd)}}.  Page 0 is the engine's reserved null page (masked writes land
    there).  Fill depth lives in the block table + lengths the caller
    passes to each step."""
    tfm.require_paged_family(cfg, "paged cache")
    shape = (tfm.n_blocks(cfg), n_pages, page_size, cfg.kv_heads(),
             cfg.head_dim_())
    dt = torch_dtype(cfg)
    return {"blocks": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def _paged_layers(cfg, params, cache, x, q_pos, table, lengths, window,
                  impl, cow):
    blocks = cache["blocks"]
    win = cfg.sliding_window if window is None else window
    for i, bp in enumerate(params.layers()):
        x = tfm.block_decode_paged(
            cfg, bp, x, q_pos, table, lengths,
            {"k": blocks["k"][i], "v": blocks["v"][i]}, window=win,
            impl=impl, cow=cow)
    return x


def paged_decode_step(cfg: ModelConfig, params: Transformer, cache,
                      token: torch.Tensor, pos: torch.Tensor,
                      table: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None, impl: str = "gather",
                      cow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One paged decode step.  token: (B, 1) int; pos: (B,) write
    positions; table: (B, P) block table; lengths: (B,) live tokens incl.
    this one (0 = inactive row, output garbage, writes -> null page);
    cow: optional (src, dst) copy-on-write page pairs.

    Returns (logits (B, 1, V), cache); the cache's pools are updated in
    place."""
    x = params.embed[token.long()]
    q_pos = pos.to(torch.int32)[:, None]
    x = _paged_layers(cfg, params, cache, x, q_pos, table, lengths, window,
                      impl, cow)
    return _logits(params, x), cache


def paged_verify_step(cfg: ModelConfig, params: Transformer, cache,
                      tokens: torch.Tensor, pos: torch.Tensor,
                      table: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None, impl: str = "gather",
                      cow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Paged-layout speculative verification: the (B, Q) span twin of
    `paged_decode_step`, scoring every draft position in one dispatch
    (through the paged-attention kernel with q_span = Q for
    impl="kernel").

    tokens: (B, Q) int, [current token, draft_1..draft_{Q-1}] per row;
    pos: (B,) absolute position of each row's first token; table: (B, P)
    block table; lengths: (B,) live tokens INCLUDING the span's real ones
    (pos + n_new; 0 = inactive row).  Draft padding past a row's length
    writes to the null page and is causally invisible to valid positions.
    cow: optional (src, dst) copy-on-write page pairs (only the span's
    first page can be shared).  Returns (logits (B, Q, V), cache); the
    pools are updated in place."""
    B, Q = tokens.shape
    x = params.embed[tokens.long()]
    q_pos = (pos.to(torch.int32)[:, None]
             + torch.arange(Q, dtype=torch.int32, device=tokens.device))
    x = _paged_layers(cfg, params, cache, x, q_pos, table, lengths, window,
                      impl, cow)
    return _logits(params, x), cache


def paged_prefill_chunk(cfg: ModelConfig, params: Transformer, cache,
                        tokens: torch.Tensor, offset: torch.Tensor,
                        chunk_end: torch.Tensor, table: torch.Tensor, *,
                        window: Optional[int] = None, impl: str = "gather"
                        ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One chunk of an incremental (chunked) prefill.

    tokens: (B, C) the next C prompt tokens of each row, right-padded;
    offset: (B,) absolute position of each row's first chunk token;
    chunk_end: (B,) live length after this chunk (0 marks an inactive
    row).  The chunk attends the row's paged context plus itself (causal by
    absolute position) and writes its K/V rows into the pages in place.

    Returns (last-token logits (B, 1, V), cache)."""
    B, C = tokens.shape
    x = params.embed[tokens.long()]
    q_pos = (offset.to(torch.int32)[:, None]
             + torch.arange(C, dtype=torch.int32, device=tokens.device)[None])
    x = _paged_layers(cfg, params, cache, x, q_pos, table, chunk_end, window,
                      impl, None)
    last = torch.clamp(chunk_end - offset - 1, 0, C - 1).long()
    x_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1,
                                                           x.shape[-1]))
    return _logits(params, x_last), cache
