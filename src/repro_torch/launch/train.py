"""Real training loop of the port: Chicle elastic data-parallel training
of the LM archs on one device (the GPU unless the caller asks for the CPU).

Integrates the full stack: synthetic LM data -> ChunkStore -> uni-task
assignment + policies (elastic schedule, rebalancing) -> ChunkBatchPipeline
(per-example Chicle weights) -> train step -> checkpointing; the JAX
package's `launch/train.py` loop line for line.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --smoke --steps 50 --global-batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
      --scale 100m --steps 300 --elastic 8:4,30:2,60:4
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \
      --smoke --device cpu

vlm and audio batches carry a `memory` stream of stub zeros (B, T,
d_model) in the model's dtype, as the JAX package's loop does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs import TrainConfig, get_config, smoke_variant
from ..core import (Assignment, ChunkStore, ElasticScalingPolicy,
                    RebalancePolicy, ScaleEvent)
from ..data import ChunkBatchPipeline, make_lm_tokens
from ..models import model as M
from ..obs import PROGRAM_TRACER
from ..optim import init_opt_state
from . import steps


def scale_config(cfg, scale: str):
    """Reduced real-training variants (the JAX package's presets)."""
    presets = {
        "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                     head_dim=32, d_ff=256, vocab_size=512),
        "25m": dict(num_layers=6, d_model=384, num_heads=6, num_kv_heads=2,
                    head_dim=64, d_ff=1024, vocab_size=8192),
        "100m": dict(num_layers=12, d_model=640, num_heads=10,
                     num_kv_heads=2, head_dim=64, d_ff=1792,
                     vocab_size=32768),
    }
    upd = dict(presets[scale])
    if cfg.num_experts:
        upd["num_experts"] = min(cfg.num_experts, 4)
    if cfg.encoder_layers:
        upd["encoder_layers"] = 2
        upd["encoder_seq"] = 32
    if cfg.num_image_tokens:
        upd["num_image_tokens"] = 32
    upd["dtype"] = "float32"
    return dataclasses.replace(cfg, **upd)


def parse_elastic(s: Optional[str]):
    """'step:workers,step:workers' -> ScaleEvents keyed on sim_time=step."""
    if not s:
        return []
    out = []
    for part in s.split(","):
        at, n = part.split(":")
        out.append(ScaleEvent(float(at), int(n)))
    return out


def build_data(cfg, *, n_seqs: int, seq_len: int, chunk_size: int, seed: int):
    toks = make_lm_tokens(n_seqs, seq_len, cfg.vocab_size, seed=seed)
    return ChunkStore({"tokens": toks["tokens"], "labels": toks["labels"]},
                      chunk_size=chunk_size)


def scheduled_batch(it: int, pipe: ChunkBatchPipeline, policies, *,
                    seed: int, stats: Dict) -> Dict[str, np.ndarray]:
    """Step `it`'s scheduler phase, then its batch: the policies run
    between iterations against a lightweight engine whose clock is the
    STEP index (deterministic), then the assignment enters the iteration.
    The caller ends it (`pipe.assignment.end_iteration()`) after the step.
    A ``train.schedule`` span of `obs.PROGRAM_TRACER`.
    """
    with PROGRAM_TRACER.span("train.schedule"):
        eng = type("E", (), {"sim_time": float(it),
                             "assignment": pipe.assignment,
                             "store": pipe.store,
                             "rng": np.random.default_rng(seed + it),
                             "on_worker_added": lambda *_: None,
                             "on_worker_removed": lambda *_: None})()
        for p in policies:
            p.between_iterations(eng, stats)
        pipe.assignment.begin_iteration()
        return pipe.next_batch()


def train(arch: str, *, scale: Optional[str] = None, smoke: bool = False,
          train_steps: int = 50, global_batch: int = 8, seq_len: int = 128,
          workers: int = 4, elastic: Optional[str] = None,
          rebalance: bool = False, hetero: Optional[str] = None,
          ckpt_dir: Optional[str] = None, log_every: int = 10,
          lr: float = 3e-3, seed: int = 0, device="cuda") -> Dict:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    cfg = get_config(arch)
    cfg = smoke_variant(cfg) if smoke else scale_config(cfg, scale or "25m")
    tc = TrainConfig(learning_rate=lr, optimizer="sgdm", momentum=0.9,
                     remat=False)

    store = build_data(cfg, n_seqs=max(global_batch * 8, 256),
                       seq_len=seq_len, chunk_size=8, seed=seed)
    assignment = Assignment(store.n_chunks, workers,
                            np.random.default_rng(seed))
    pipe = ChunkBatchPipeline(store, assignment, global_batch=global_batch,
                              seed=seed)
    policies = []
    if elastic:
        policies.append(ElasticScalingPolicy(parse_elastic(elastic)))
    if rebalance:
        policies.append(RebalancePolicy())
    node_pst = (lambda w: 1.0)
    if hetero:  # e.g. "2.0x4" -> first 4 workers 2x slower
        factor, count = hetero.split("x")
        node_pst = (lambda w, f=float(factor), c=int(count):
                    f if w < c else 1.0)

    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device)
    opt_state = init_opt_state(M.param_dict(params), optimizer=tc.optimizer)
    step_fn = steps.make_train_step(cfg, tc)

    # lightweight engine loop (scheduler phase -> batch -> train step)
    sim_time = 0.0
    history = []
    t0 = time.time()
    for it in range(train_steps):
        stats: Dict = {}
        batch = steps.to_device(
            scheduled_batch(it, pipe, policies, seed=seed, stats=stats),
            device)
        if steps.memory_len(cfg):  # audio frames / vlm patches: stub zeros
            batch["memory"] = torch.zeros(
                (global_batch, steps.memory_len(cfg), cfg.d_model),
                dtype=M.torch_dtype(cfg), device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        assignment.end_iteration()

        # simulated elastic time: iteration cost = slowest worker
        counts = assignment.sample_counts(store).astype(float)
        shares = counts / max(counts.sum(), 1.0)
        task_times = {w: shares[w] * node_pst(w)
                      for w in range(assignment.n_workers)}
        stats["per_sample_times"] = {w: node_pst(w)
                                     for w in range(assignment.n_workers)}
        stats["task_times"] = task_times
        sim_time += max(task_times.values())
        loss = float(metrics["loss"])  # waits for the step
        wall = time.time() - t0
        history.append({"step": it, "loss": loss,
                        "workers": assignment.n_workers,
                        "sim_time": sim_time,
                        "events": list(stats.get("scale_events", [])),
                        "wall_s": wall})
        if it % log_every == 0 or it == train_steps - 1:
            print(f"step {it:4d} loss {loss:8.4f} "
                  f"workers {assignment.n_workers:2d} "
                  f"wall {wall:6.1f}s", flush=True)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, train_steps, params, opt_state,
                        assignment=assignment)
    return {"history": history, "params": params, "cfg": cfg}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--scale", default=None,
                    choices=[None, "tiny", "25m", "100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--elastic", default=None,
                    help="'step:workers,...' schedule")
    ap.add_argument("--rebalance", action="store_true")
    ap.add_argument("--hetero", default=None, help="e.g. 2.0x4")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    out = train(args.arch, scale=args.scale, smoke=args.smoke,
                train_steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq, workers=args.workers, elastic=args.elastic,
                rebalance=args.rebalance, hetero=args.hetero,
                ckpt_dir=args.ckpt_dir, lr=args.lr, device=args.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
