"""Plain reference of a dense GQA decoder's Chicle-weighted training step:
float32 PyTorch, no kernels of the program and nothing of its package.

The model is the configuration's: token embedding, then per layer an RMS
norm, q/k/v projections, half-split rotary embedding on q and k, causal
attention (each query sees the `sliding_window` latest positions, itself
included) with each group of num_attention_heads / num_key_value_heads
query heads reading one KV head, the output projection and a residual add,
an RMS norm and a SwiGLU MLP with a residual add; a final RMS norm and the
output head (the embedding transposed when `tie_word_embeddings`).  The
loss is each example's mean token cross-entropy, weighted by the batch's
per-example weights and divided by their sum.  The optimizer is SGD with
momentum: mu = momentum mu + g (float32), then each parameter, stored in
the configuration's dtype, becomes (p + (-lr) mu) rounded back to it.

TF32 is switched off for the reference's products.  `quant="fp8"` is the
control: every projection's and the head's two operands rounded to
float8 e4m3 with a per-tensor scale (gradients pass straight through), the
precision below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np


def _q8(torch, t):
    """Round to float8 e4m3 with a per-tensor scale; identity gradient."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = amax / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t.detach())


class LMReference:
    def __init__(self, torch, c: Dict, weights: Dict[str, "torch.Tensor"],
                 *, quant: Optional[str] = None, q_block: int = 512,
                 row_block: int = 2):
        """`weights`: the leaves by path (`pb_inputs.lm_layout`) in the
        configuration's dtype; the reference keeps its own copies.  A step
        runs its batch `row_block` rows at a time, the gradients summed."""
        self.t = torch
        self.c = c
        self.quant = quant
        self.q_block = q_block
        self.row_block = row_block
        tc = c["train"]
        self.lr, self.momentum = tc["learning_rate"], tc["momentum"]
        self.store = {k: v.detach().clone() for k, v in weights.items()}
        self.mu = {k: torch.zeros(v.shape, dtype=torch.float32,
                                  device=v.device)
                   for k, v in weights.items()}

    # -- model ---------------------------------------------------------------
    def _mm(self, a, b):
        if self.quant == "fp8":
            a, b = _q8(self.t, a), _q8(self.t, b)
        return a @ b

    def _rms(self, x, w):
        t = self.t
        return x * t.rsqrt(x.square().mean(-1, keepdim=True)
                           + self.c["rms_norm_eps"]) * w

    def _rope(self, x, cos, sin):
        half = x.shape[-1] // 2
        x1, x2 = x[..., :half], x[..., half:]
        return self.t.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _layer(self, x, cos, sin, ln1, wq, wk, wv, wo, ln2, gate, up, down):
        t, c = self.t, self.c
        B, S, D = x.shape
        H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
        win = c["sliding_window"]
        h = self._rms(x, ln1)
        q = self._mm(h, wq.reshape(D, H * hd)).view(B, S, H, hd)
        k = self._mm(h, wk.reshape(D, KV * hd)).view(B, S, KV, hd)
        v = self._mm(h, wv.reshape(D, KV * hd)).view(B, S, KV, hd)
        q, k = self._rope(q, cos, sin), self._rope(k, cos, sin)
        g = H // KV
        qt = q.transpose(1, 2) / math.sqrt(hd)  # (B, H, S, hd)
        kt = k.repeat_interleave(g, dim=2).permute(0, 2, 3, 1)  # (B,H,hd,S)
        vt = v.repeat_interleave(g, dim=2).transpose(1, 2)  # (B, H, S, hd)
        kpos = t.arange(S, device=x.device)
        outs = []
        for q0 in range(0, S, self.q_block):
            qpos = kpos[q0:q0 + self.q_block]
            d = qpos[:, None] - kpos[None, :]
            ok = d >= 0
            if win:
                ok = ok & (d < win)
            sc = (qt[:, :, q0:q0 + self.q_block] @ kt).masked_fill(
                ~ok, float("-inf"))
            outs.append(t.softmax(sc, dim=-1) @ vt)
        ctx = t.cat(outs, dim=2).transpose(1, 2).reshape(B, S, H * hd)
        x = x + self._mm(ctx, wo.reshape(H * hd, D))
        h2 = self._rms(x, ln2)
        f = self._mm(t.nn.functional.silu(self._mm(h2, gate))
                     * self._mm(h2, up), down)
        return x + f

    def loss(self, P: Dict, tokens, labels, weights, total_weight=None):
        """Weighted mean cross-entropy of float32 leaves `P` on one batch:
        the weighted sum over its rows, over `total_weight` (default the
        sum of `weights`; a block of a batch gives its batch's)."""
        t, c = self.t, self.c
        from torch.utils.checkpoint import checkpoint
        B, S = tokens.shape
        hd = c["head_dim"]
        half = hd // 2
        freqs = 1.0 / (c["rope_theta"] ** (t.arange(
            0, half, dtype=t.float32, device=tokens.device) / half))
        ang = t.arange(S, dtype=t.float32, device=tokens.device)[:, None] \
            * freqs
        cos, sin = t.cos(ang)[None, :, None], t.sin(ang)[None, :, None]
        x = P["embed"][tokens.long()]
        names = ("ln1", "attn/wq", "attn/wk", "attn/wv", "attn/wo", "ln2",
                 "mlp/gate", "mlp/up", "mlp/down")
        for li in range(c["num_hidden_layers"]):
            leaves = [P[f"blocks/{n}"][li] for n in names]
            x = checkpoint(self._layer, x, cos, sin, *leaves,
                           use_reentrant=False)
        head = P["embed"] if c["tie_word_embeddings"] else P["lm_head"]
        logits = self._mm(self._rms(x, P["final_ln"]), head.t())
        lse = t.logsumexp(logits, dim=-1)
        picked = t.gather(logits, -1, labels.long()[..., None])[..., 0]
        per_ex = (lse - picked).mean(-1)
        w = weights.float()
        return (per_ex * w).sum() / (w.sum() if total_weight is None
                                     else total_weight)

    # -- training ------------------------------------------------------------
    def step(self, tokens, labels, weights) -> Tuple[float, Dict[str, float]]:
        """One training step; returns (loss, gradient norm per leaf)."""
        t = self.t
        was = (t.backends.cuda.matmul.allow_tf32, t.backends.cudnn.allow_tf32)
        t.backends.cuda.matmul.allow_tf32 = False
        t.backends.cudnn.allow_tf32 = False
        try:
            P = {k: v.to(t.float32, copy=True).requires_grad_(True)
                 for k, v in self.store.items()}
            total_w = weights.float().sum()
            loss = 0.0
            with t.enable_grad():
                for r0 in range(0, tokens.shape[0], self.row_block):
                    rows = slice(r0, r0 + self.row_block)
                    part = self.loss(P, tokens[rows], labels[rows],
                                     weights[rows], total_w)
                    part.backward()
                    loss += float(part.detach())
            grads = [p.grad for p in P.values()]
            del P
            norms = {}
            with t.no_grad():
                for (k, m), g in zip(self.mu.items(), grads):
                    norms[k] = float(g.norm())
                    m.mul_(self.momentum).add_(g)
                    p = self.store[k]
                    p.copy_((p.float() - self.lr * m).to(p.dtype))
            return loss, norms
        finally:
            (t.backends.cuda.matmul.allow_tf32,
             t.backends.cudnn.allow_tf32) = was


def chicle_weights(n_chunks: int, chunk_size: int, ks: List[int],
                   batch: int) -> List[np.ndarray]:
    """The per-example weights of each step's batch, worked out from the
    Chicle rules alone: the chunks start dealt round-robin over the first
    step's workers; a scale-in hands each revoked worker's chunks
    round-robin to the rest, the last worker first; a scale-out gives the
    new worker n_chunks // K chunks, one at a time from each older worker
    in turn that keeps more than one.  A worker's share is its samples
    over all; it draws max(1, round(share B)) examples (the largest count
    trimmed, the smallest raised, until they sum to B), each weighing
    share B / its examples."""
    counts = [len(range(w, n_chunks, ks[0])) for w in range(ks[0])]
    out = []
    for k in ks:
        while len(counts) > k:
            moved = counts.pop()
            for i in range(moved):
                counts[i % len(counts)] += 1
        while len(counts) < k:
            counts.append(0)
            share = n_chunks // len(counts)
            donors, i = len(counts) - 1, 0
            while counts[-1] < share and donors:
                d = i % donors
                if counts[d] > 1:
                    counts[d] -= 1
                    counts[-1] += 1
                i += 1
                if i > 10 * n_chunks:
                    break
        samples = np.array(counts, np.float64) * chunk_size
        shares = samples / max(samples.sum(), 1.0)
        per = np.maximum(1, np.round(shares * batch)).astype(int)
        while per.sum() > batch:
            per[np.argmax(per)] -= 1
        while per.sum() < batch:
            per[np.argmin(per)] += 1
        out.append(np.concatenate([np.full(per[w], shares[w] * batch / per[w],
                                           np.float32)
                                   for w in range(k)]))
    return out
