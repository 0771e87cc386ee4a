"""The benchmark's yardstick: frozen copies of the arithmetic that turns a
run into numbers, kept here so that a change to the program cannot move
them.  Each piece names the file it was copied from (at the commit that
added this benchmark); the program's own copies may change freely.

- H100 peaks: `src/repro_torch/launch/roofline.py` (`PEAK_FLOPS`,
  `HBM_BW`), the published rates of the H100 SXM part at 700 W.
- `scd_work`, `roofline_s`: `chip_smoke.py` (`scd_work`, `bound`).
- `lm_train_flops`: `src/repro_torch/launch/roofline.py`
  (`model_flops_for`: 6 N D) with attention added, as the benchmark's
  model flops count them (no recomputation).
- `device_summary`: the profiler reading of `chip_smoke.py`
  (`profile_run`: device time from the profiler's CUDA events), extended
  from sums to intervals: busy time as the union of device intervals in a
  window, idle gaps between them, and what the host was doing in each.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, per second
HBM_BW = 3.35e12  # bytes per second


def roofline_s(nbytes: float, flops: float, dtype: str = "float32") -> float:
    """The least time a kernel can take: each byte moved once at the HBM
    rate, or its operations at the dtype's peak, whichever is longer."""
    return max(nbytes / HBM_BW, flops / PEAK_FLOPS[dtype])


def scd_work(K: int, M: int, F: int) -> Tuple[int, int]:
    """(bytes, flops) of one SCD pass: x, y, alpha, mask, w and sigma read
    once, v_end and da written once; per step 6F flops (dot, |x|^2 and the
    update) and ~12 scalar ones."""
    nbytes = 4 * (K * M * F + 3 * K * M + F + K + K * F + K * M)
    return nbytes, K * M * (6 * F + 12)


def lm_matmul_params(c: Dict) -> int:
    """Parameters of a dense GQA decoder that multiply activations: the
    q/k/v/o projections and the SwiGLU MLP of every layer, and the output
    head (tied or not, it multiplies); not the embedding lookup or the
    norm scales."""
    D, L = c["hidden_size"], c["num_hidden_layers"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd, Fd, V = c["head_dim"], c["intermediate_size"], c["vocab_size"]
    per_layer = D * hd * (2 * H + 2 * KV) + 3 * D * Fd
    return L * per_layer + V * D


def visible_pairs(S: int, window: int) -> int:
    """Query-key pairs a causal sequence of S tokens attends over, each
    query seeing the `window` latest positions (itself included); window 0
    is full causal attention."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def lm_train_flops(c: Dict, batch: int, seq: int) -> float:
    """Model flops of one training step (forward and backward, no
    recomputation): 6 per matmul parameter per token, plus attention's
    12 hd per visible query-key pair per head per layer (QK^T and PV, 2 hd
    each forward, three times that with backward)."""
    dense = 6.0 * lm_matmul_params(c) * batch * seq
    attn = (12.0 * c["head_dim"] * visible_pairs(seq, c["sliding_window"])
            * c["num_attention_heads"] * c["num_hidden_layers"] * batch)
    return dense + attn


# ---------------------------------------------------------------------------
# The profiler's trace, reduced to busy time, idle gaps and top operations
# ---------------------------------------------------------------------------


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def device_summary(events: Iterable, span: str, *, top: int = 10,
                   gaps_named: int = 4000) -> Optional[Dict]:
    """Reduce a profiler's events (`prof.events()`) to what the benchmark
    reports.  The traced window runs from the start of the first host
    span named `span` to the end of the last (each of the benchmark's
    steps ends by waiting for the device, so its kernels end inside it).

    Returns None when the trace holds no such span or no device event
    inside the window, else {"window_s", "busy_s" (the union of device
    intervals clipped to the window), "device_ops" (the `top` device
    operations by time, [name, seconds]), "idle_gaps" (idle time by what
    the host was doing: the innermost host event covering each gap's
    midpoint, for the `gaps_named` longest gaps; [name, seconds])}."""
    import numpy as np
    dev, host, spans = [], [], []
    for e in events:
        tr = e.time_range
        kind = getattr(e.device_type, "name", str(e.device_type))
        if kind == "CUDA":
            # the host's annotations are mirrored on the device's timeline
            # as ranges that span its kernels: not device work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(("pb.", "ProfilerStep#"))):
                dev.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
            if e.name == span:
                spans.append((tr.start, tr.end))
    if not spans:
        return None
    w0 = min(s for s, _ in spans)
    w1 = max(e for _, e in spans)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev
              if e > w0 and s < w1]
    if not inside:
        return None
    busy = _union([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    per_op: Dict[str, float] = {}
    for s, e, n in inside:
        per_op[n] = per_op.get(n, 0.0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named: Dict[str, float] = {}
    if host and gaps:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        hd = he - hs
        for g0, g1 in gaps[:gaps_named]:
            m = 0.5 * (g0 + g1)
            cover = np.nonzero((hs <= m) & (he >= m))[0]
            name = ("(no host event)" if not len(cover) else
                    host[int(cover[np.argmin(hd[cover])])][2])
            named[name] = named.get(name, 0.0) + (g1 - g0)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[n, t / 1e6] for n, t in idle]}
