"""Speculative decoding for the slot pool: drafters and greedy accept.

Greedy decoding is lossless to speculate on: if a drafter guesses the next
k tokens and the model scores all k+1 positions (current token + k drafts)
in ONE batched forward, the argmax at position j is exactly the token a
sequential greedy decode would emit after consuming the matching prefix.
Accepting the longest matching draft prefix plus the model's own token at
the first mismatch therefore gives the non-speculative token stream, at up
to k+1 tokens per dispatch.

Drafters are pluggable and never affect the stream, only the acceptance
rate:

- `NgramDrafter`: prompt-lookup decoding.  The longest suffix n-gram of a
  slot's context (prompt + emitted tokens) is matched against its earlier
  occurrences and the continuation is proposed.  Host only, no model work.
- `DraftModelDrafter`: a small autoregressive draft model proposes k
  tokens (one batched prefill over every active slot's context, then k-1
  flat-cache decode steps) on the engine's device.

The engine verifies the drafts through `models.model.paged_verify_step` /
`verify_step` (one (B, Q=k+1) dispatch) and calls `greedy_accept` per slot.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .pages import next_pow2


def greedy_accept(draft: np.ndarray, verified: np.ndarray) -> int:
    """Longest prefix of `draft` matching the model's own argmax stream.

    verified[j] is the model's greedy token AFTER consuming the current
    token and drafts[0..j-1]; the caller emits verified[0..m] (the m
    matching drafts are verified[0..m-1] themselves, plus the model's
    correction/extension at the first mismatch).
    """
    m = 0
    while m < len(draft) and int(draft[m]) == int(verified[m]):
        m += 1
    return m


class NgramDrafter:
    """Prompt-lookup n-gram drafting (suffix match over the slot's own
    context).  For each slot, the longest suffix n-gram (max_ngram down to
    min_ngram) is matched against its most recent earlier occurrence in
    prompt + emitted tokens; the tokens that followed it are the draft.

    max_lookback bounds the scanned context tail so per-tick host work
    stays O(lookback) instead of growing with the stream."""

    dispatches_per_propose = 0  # pure host lookup: no device dispatch

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_lookback: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram; got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_lookback = max_lookback

    def on_resize(self, device) -> None:  # host-only state: no-op
        pass

    def propose(self, contexts: Sequence[np.ndarray],
                k: int) -> List[np.ndarray]:
        return [self._one(np.asarray(c, np.int64)[-self.max_lookback:], k)
                for c in contexts]

    def _one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        n = len(ctx)
        if k <= 0 or n < self.min_ngram + 1:
            return np.empty(0, np.int64)
        for g in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pat = ctx[n - g:]
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], g)
            hits = np.nonzero((windows == pat).all(axis=1))[0]
            if not len(hits):
                continue
            # most recent occurrence wins (local loops dominate), but prefer
            # one whose continuation fills the whole k-token draft budget —
            # on a periodic context the latest match sits flush against the
            # suffix and would truncate the draft for no reason
            best = int(hits[-1])
            if n - (best + g) < k:
                for h in hits[::-1]:
                    if n - (int(h) + g) >= k:
                        best = int(h)
                        break
                else:
                    best = int(hits[0])  # earliest = longest continuation
            cont = ctx[best + g: best + g + k]
            if len(cont):
                return cont.astype(np.int64)
        return np.empty(0, np.int64)


class DraftModelDrafter:
    """Draft-model drafting: one batched prefill over every active slot's
    context, then k-1 batched flat-cache decode steps, at power-of-two
    batch and length buckets (the JAX package's compile buckets, kept so
    the drafts are the same: pad rows and pad positions are masked).

    The draft model is greedy too, so with `params` == the target model's
    params the drafts are the target's own stream and acceptance is 100%.
    Without params it starts from random weights made from `seed` on
    `device` (CUDA unless the caller asks for the CPU)."""

    dispatches_per_propose = 1  # one batched drafting pass per tick

    def __init__(self, cfg, params=None, *, seed: int = 0, device="cuda"):
        from ..models import model as M
        self.cfg = cfg
        self.device = torch.device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen, self.device)
        self.params = params.to(self.device)

    def on_resize(self, device) -> None:
        """Follow the engine's pool onto `device` (a no-op on the same
        device)."""
        self.device = torch.device(device)
        self.params = self.params.to(self.device)

    @torch.inference_mode()
    def propose(self, contexts: Sequence[np.ndarray],
                k: int) -> List[np.ndarray]:
        from ..models import model as M
        n = len(contexts)
        if n == 0 or k <= 0:
            return [np.empty(0, np.int64) for _ in range(n)]
        nb = next_pow2(n)
        L = next_pow2(max(max(len(c) for c in contexts), 1))
        toks = np.zeros((nb, L), np.int32)
        lens = np.ones(nb, np.int32)  # pad rows decode garbage, discarded
        for i, c in enumerate(contexts):
            toks[i, : len(c)] = c
            lens[i] = max(len(c), 1)
        dev = self.device
        pos = torch.from_numpy(lens).to(dev)
        last, cache = M.prefill(self.cfg, self.params,
                                torch.from_numpy(toks).to(dev),
                                cache_len=L + k, true_len=pos)
        # the prefill's token is draft 1; k-1 decode steps finish the span
        tok = last[:, -1].argmax(-1).to(torch.int32)
        out = [tok]
        for _ in range(k - 1):
            logits, cache = M.decode_step(self.cfg, self.params, cache,
                                          tok[:, None], pos)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            out.append(tok)
            pos = pos + 1
        drafts = torch.stack(out, 1).cpu().numpy()  # (nb, k)
        return [drafts[i].astype(np.int64) for i in range(n)]
