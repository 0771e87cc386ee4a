"""The port's Chicle LM training as a benchmark system (`system: lm_train`).

Set-up builds the port's pieces of `launch.train` at the configuration's
full width: a `ChunkStore` of the benchmark's token rows, an `Assignment`,
a `ChunkBatchPipeline`, an `ElasticScalingPolicy` that follows the
traffic's worker schedule by step, and `launch.steps.make_train_step` over
the benchmark's weights.  It drives that one training object through its
first `checked_steps` steps (which also warm every shape the cell uses)
and hands it to the window, which goes on with the same calls: each step
is `scheduled_batch` + `steps.to_device` (timed as `sched`) and the train
step, ending when the step's loss reaches the host.

The check follows the first `checked_steps` steps in the plain reference
(`reference/lm_ref.py`): each step's loss, the first gradient as the
optimizer holds it (sgdm's momentum after one step is that gradient), and
each leaf's change after the checked steps; and every step's per-example
weights against the Chicle rules.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

import pb_inputs


class Cell:
    FAULTS = ("frozen", "half_batch", "double_leaf")

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device: str,
                 fault: Optional[str] = None, program: str = "port"):
        import torch
        if fault is not None and fault not in self.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.torch = torch
        self.c, self.tr, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.fault, self.program = fault, program
        self.ks = pb_inputs.worker_schedule(traffic)
        self.steps = 0  # steps done, set-up's included
        self.window_steps = 0
        self.sched_s = 0.0  # scheduler + batch to device, window steps
        self.steps_s = 0.0  # the window steps' own wall time
        self.log: List[Dict] = []  # per step: K and the batch's weights

    # -- the program -------------------------------------------------------
    def _port_config(self):
        from repro_torch.configs import get_config
        c = self.c
        return dataclasses.replace(
            get_config(c["port_arch"]), num_layers=c["num_hidden_layers"],
            d_model=c["hidden_size"], num_heads=c["num_attention_heads"],
            num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
            sliding_window=c["sliding_window"], rope_theta=c["rope_theta"],
            dtype=c["torch_dtype"])

    def setup(self) -> None:
        torch, c, tr = self.torch, self.c, self.tr
        from repro_torch.configs import TrainConfig
        from repro_torch.core import (Assignment, ChunkStore,
                                      ElasticScalingPolicy)
        from repro_torch.data import ChunkBatchPipeline
        from repro_torch.launch import steps, train
        from repro_torch.models import model as M
        from repro_torch.optim import init_opt_state
        self.steps_mod, self.train_mod, self.M = steps, train, M
        rows = pb_inputs.lm_tokens(torch, c, tr["n_seqs"], tr["seq_len"],
                                   self.seed, self.device)
        self.rows = rows
        self.store = ChunkStore({"tokens": rows[:, :-1],
                                 "labels": rows[:, 1:]},
                                chunk_size=tr["chunk_size"])
        self.assignment = Assignment(self.store.n_chunks, self.ks[0],
                                     np.random.default_rng(self.seed))
        self.pipe = ChunkBatchPipeline(self.store, self.assignment,
                                       global_batch=tr["batch"],
                                       seed=self.seed)
        ks = self.ks
        self.policies = [ElasticScalingPolicy(
            lambda t: ks[int(t) % len(ks)])]
        self.mcfg = self._port_config()
        t = c["train"]
        self.tc = TrainConfig(learning_rate=t["learning_rate"],
                              momentum=t["momentum"],
                              optimizer=t["optimizer"],
                              weight_decay=t["weight_decay"],
                              remat=t["remat"], accum_steps=t["accum_steps"])
        want = {p: s for p, s, _ in pb_inputs.lm_layout(c)}
        have = {p: tuple(v.shape)
                for p, v in M.param_dict(M.Transformer(
                    self.mcfg, M.param_sds(self.mcfg))).items()}
        if want != have:
            raise RuntimeError(f"the port's parameter layout {have} is not "
                               f"the benchmark's {want}")
        if self.program == "port":
            w = pb_inputs.lm_weights(torch, c, self.seed, self.device)
            self.params = M.params_from_paths(self.mcfg, w)
            self.opt = init_opt_state(M.param_dict(self.params),
                                      optimizer=self.tc.optimizer)
            step_fn = steps.make_train_step(self.mcfg, self.tc)
            self.step_fn = self._planted(step_fn)
        else:  # the control: the reference at the precision below, in place
            from reference import lm_ref as ref
            w = pb_inputs.lm_weights(torch, c, self.seed, self.device)
            self.ctl = ref.LMReference(torch, c, w, quant=self.program)
            del w
        self.checked = {"loss": [], "batches": []}
        for i in range(tr["checked_steps"]):
            self._step(window=False)
            if i == 0:
                self.checked["grad"] = self._grad_norms()
        self.checked["change"] = self._change_norms()

    def _planted(self, step_fn):
        """The train step, with the fault under test planted in it."""
        torch, M = self.torch, self.M
        if self.fault is None:
            return step_fn
        if self.fault == "frozen":
            def frozen(params, opt, batch):
                return params, opt, {"loss": M.loss_fn(
                    self.mcfg, params, batch, remat=False)[1]["loss"]}
            return frozen
        if self.fault == "half_batch":
            def half(params, opt, batch):
                b = batch["tokens"].shape[0] // 2
                return step_fn(params, opt, {k: v[:max(b, 1)]
                                             for k, v in batch.items()})
            return half

        def double(params, opt, batch):  # one leaf moved twice
            leaf = M.param_dict(params)["blocks/mlp/up"]
            before = leaf.detach().clone()
            out = step_fn(params, opt, batch)
            with torch.no_grad():
                leaf.copy_((2 * leaf.float() - before.float()).to(leaf.dtype))
            return out
        return double

    def _grad_norms(self) -> Dict[str, float]:
        """Each leaf's first gradient as the optimizer holds it: sgdm's
        momentum after one step from zero."""
        if self.program != "port":
            return dict(self._ctl_grad)
        return {k: float(m.norm()) for k, m in self.opt.mu.items()}

    def _change_norms(self) -> Dict[str, float]:
        """Each leaf's change since the start, as the next step gets it."""
        torch = self.torch
        w0 = pb_inputs.lm_weights(torch, self.c, self.seed, self.device)
        now = (self.M.param_dict(self.params) if self.program == "port"
               else self.ctl.store)
        out = {k: float((now[k].detach().float() - w0[k].float()).norm())
               for k in w0}
        del w0
        return out

    def _step(self, *, window: bool) -> None:
        torch = self.torch
        it = self.steps
        stats: Dict = {}
        t0 = time.perf_counter()
        with torch.profiler.record_function("pb.sched"):
            batch_np = self.train_mod.scheduled_batch(
                it, self.pipe, self.policies, seed=self.seed, stats=stats)
            batch = self.steps_mod.to_device(batch_np, self.device)
        t1 = time.perf_counter()
        with torch.profiler.record_function("pb.train_step"):
            if self.program == "port":
                self.params, self.opt, m = self.step_fn(self.params,
                                                        self.opt, batch)
                loss = float(m["loss"])  # waits for the step
            else:
                loss, grads = self.ctl.step(batch["tokens"], batch["labels"],
                                            batch["weights"])
                if it == 0:
                    self._ctl_grad = grads
        self.assignment.end_iteration()
        if window:
            self.sched_s += t1 - t0
            self.steps_s += time.perf_counter() - t0
            self.window_steps += 1
        self.log.append({"K": self.assignment.n_workers,
                         "weights": batch_np["weights"]})
        if not window:
            self.checked["loss"].append(loss)
            self.checked["batches"].append(
                {k: batch_np[k] for k in ("tokens", "labels")})
        self.steps += 1

    def step(self) -> None:
        self._step(window=True)

    # -- what the run reports ----------------------------------------------
    def end_to_end(self, window_s: float) -> Dict[str, float]:
        tokens = self.window_steps * self.tr["batch"] * self.tr["seq_len"]
        return {"train_tokens_per_s": tokens / window_s}

    def layer_context(self) -> Dict:
        return {"steps": self.window_steps, "sched_s": self.sched_s,
                "steps_s": self.steps_s,
                "batch": self.tr["batch"], "seq_len": self.tr["seq_len"]}

    def attempted(self) -> int:
        return self.window_steps

    def release(self) -> None:
        for name in ("params", "opt", "step_fn", "ctl", "pipe", "store"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def check(self, limits: Dict) -> List[Dict]:
        """The numbers compared, each {"name", "value", "limit"}."""
        torch, c, tr = self.torch, self.c, self.tr
        from reference import lm_ref as ref
        n = tr["checked_steps"]
        k_want = [self.ks[i % len(self.ks)] for i in range(len(self.log))]
        want_w = ref.chicle_weights(-(-tr["n_seqs"] // tr["chunk_size"]),
                                    tr["chunk_size"], k_want, tr["batch"])
        weights_gap = max(
            [float(np.abs(e["weights"] - w).max()) if e["weights"].shape
             == w.shape else float("inf")
             for e, w in zip(self.log, want_w)]
            + [0.0 if [e["K"] for e in self.log] == k_want else float("inf")])
        rows_bad = self._rows_not_in_store()
        w0 = pb_inputs.lm_weights(torch, c, self.seed, self.device)
        r = ref.LMReference(torch, c, w0)
        losses, grads = [], None
        for s in range(n):
            b = self.checked["batches"][s]
            toks = torch.from_numpy(np.ascontiguousarray(b["tokens"])).to(
                self.device)
            labs = torch.from_numpy(np.ascontiguousarray(b["labels"])).to(
                self.device)
            wts = torch.from_numpy(want_w[s]).to(self.device)
            loss, g = r.step(toks, labs, wts)
            losses.append(loss)
            if s == 0:
                grads = g
        change = {k: float((r.store[k].float() - w0[k].float()).norm())
                  for k in w0}
        del r, w0
        loss_gap = max(abs(a - b) / abs(b)
                       for a, b in zip(self.checked["loss"], losses))
        med_g = float(np.median(list(grads.values())))
        grad_gap = max(abs(self.checked["grad"][k] - v) / max(v, med_g)
                       for k, v in grads.items())
        moved = [k for k, v in grads.items() if v >= 1e-3 * med_g]
        med_d = float(np.median([change[k] for k in moved]))
        change_gap = max(abs(self.checked["change"][k] - change[k])
                         / max(change[k], med_d) for k in moved)
        self.readings = {"losses": self.checked["loss"], "ref_losses": losses,
                         "grad": self.checked["grad"], "ref_grad": grads,
                         "change": self.checked["change"],
                         "ref_change": change}
        return [
            {"name": "loss", "value": loss_gap, "limit": limits["loss"]},
            {"name": "grad", "value": grad_gap, "limit": limits["grad"]},
            {"name": "change", "value": change_gap,
             "limit": limits["change"]},
            {"name": "weights", "value": weights_gap,
             "limit": limits["weights"]},
            {"name": "rows", "value": float(rows_bad),
             "limit": limits["rows"]},
        ]

    def _rows_not_in_store(self) -> int:
        """Checked batch rows whose tokens and labels are no row of the
        benchmark's store."""
        index = {r[:-1].tobytes(): i for i, r in enumerate(self.rows)}
        bad = 0
        for b in self.checked["batches"]:
            for tok, lab in zip(b["tokens"], b["labels"]):
                i = index.get(np.ascontiguousarray(tok).tobytes())
                bad += i is None or not np.array_equal(self.rows[i][1:], lab)
        return bad
