"""The port's CoCoA SVM training as a benchmark system (`system: glm_cocoa`).

Set-up makes the rows and labels on the device from the seed, builds the
port's `ChunkStore`, `Assignment` and `CoCoASolver`, and a `UniTaskEngine`
whose `ElasticScalingPolicy` follows the traffic's worker schedule by
iteration; every iteration passes over all rows (no sample shares) and
ends with the duality gap, the engine's metric.  It runs the schedule
from its start until each worker count of the cycle has run once (the
first run in a checkout also builds the SCD kernel), and hands the same
engine to the window, one `engine.run(1, ...)` a step.

The harness watches three things without changing them: the solver's
shuffles (the order each worker visits its rows), the SCD pass's inputs
and outputs (bracketed by CUDA events), and the state before and after
each iteration (the chunks' alpha, the solver's w).  The check follows
the first `checked_steps` iterations of set-up (far from the optimum,
where every row still moves) in the plain reference, on the reference's
own state from the solver's start; and it replays the first iteration at
each other worker count of the cycle (its passes the longest, M = n / K)
from the program's state before it.  In each, the visit order must give
each worker whole chunks and every row once; the SCD pass is run again
from the same state and order, and v_end, da, the alpha scattered back
and the duality gap are compared (the merge into w is read beside them:
float32 rounding of w against a small move, which no control or fault
moves).  At the window's end w is held against X^T (alpha y) / (lam n),
which every merge and every move of alpha with its chunks across the
window's scale events must keep.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

import pb_inputs


class _Recorder:
    """A generator that keeps each array it shuffles (the solver's pools)."""

    def __init__(self, rng):
        self.rng, self.shuffled = rng, []

    def shuffle(self, x):
        self.rng.shuffle(x)
        self.shuffled.append(x)

    def __getattr__(self, name):
        return getattr(self.rng, name)


class Cell:
    FAULTS = ("frozen", "half_batch", "altered", "long_pass_skip")

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
        self.checked: List[Dict] = []  # the first iterations, in full
        self.replayed: List[Dict] = []  # the first at each other K
        self.rows_done = 0
        self.iters: List[Dict] = []  # window: K, M, wall, scd events
        self.passes: List = []  # (start, end, (K, M, F), outputs)
        self.last: Dict = {}

    # -- the program -------------------------------------------------------
    def setup(self) -> None:
        torch, c = self.torch, self.c
        from repro_torch.core import (Assignment, ChunkStore, CoCoASolver,
                                      ElasticScalingPolicy, UniTaskEngine)
        from repro_torch.kernels import ops
        X, y = pb_inputs.glm_rows(torch, c, self.seed, self.device)
        store = ChunkStore({"x": X.cpu().numpy(), "y": y.cpu().numpy()},
                           chunk_size=c["chunk_size"])
        del X, y
        self.store = store
        self.assignment = Assignment(store.n_chunks, self.ks[0],
                                     np.random.default_rng(self.seed))
        self.solver = CoCoASolver(store, lam=c["lambda"], seed=self.seed,
                                  device=self.device)
        self.solver.rng = _Recorder(self.solver.rng)
        ks = self.ks
        self.engine = UniTaskEngine(
            store, self.assignment,
            [ElasticScalingPolicy(
                lambda t: ks[self.engine.iteration % len(ks)])],
            seed=self.seed, balance_processing=False)
        self.ops = ops
        self.real_pass = ops.scd_local_pass
        ops.scd_local_pass = self._watched(self._planted(self.real_pass))
        todo = set(ks)
        while todo or len(self.checked) < self.tr["checked_steps"]:
            todo.discard(self.ks[self.engine.iteration % len(ks)])
            self._iteration(window=False)

    def _planted(self, scd):
        """The SCD pass the solver calls: the program's, the control's, or
        the program's with the fault under test planted in it."""
        torch = self.torch
        if self.program != "port":
            from reference import glm_ref as ref

            def control(x, y, alpha, w, mask, lam_n, sigma):
                v, da = ref.scd_pass(
                    torch, lambda i0, i1: x[:, i0:i1], y.cpu().numpy(),
                    alpha.cpu().numpy(), w, mask.cpu().numpy(), lam_n,
                    sigma.cpu().numpy(), dtype=torch.float32,
                    round_x=self.program)
                return v.float(), torch.from_numpy(da).to(x.device)
            return control
        if self.fault == "frozen":
            return lambda x, y, alpha, w, mask, lam_n, sigma: (
                w.expand(x.shape[0], -1).clone(),
                torch.zeros_like(alpha))
        if self.fault == "half_batch":
            def half(x, y, alpha, w, mask, lam_n, sigma):
                m = mask.clone()
                m[:, m.shape[1] // 2:] = 0.0
                return scd(x, y, alpha, w, m, lam_n, sigma)
            return half
        if self.fault == "long_pass_skip":  # rows skipped, v and da agree
            k_min = min(self.ks)

            def skip(x, y, alpha, w, mask, lam_n, sigma):
                if x.shape[0] != k_min:
                    return scd(x, y, alpha, w, mask, lam_n, sigma)
                m = mask.clone()
                m[:, m.shape[1] - m.shape[1] // 4:] = 0.0
                return scd(x, y, alpha, w, m, lam_n, sigma)
            return skip
        if self.fault == "altered":
            def altered(x, y, alpha, w, mask, lam_n, sigma):
                v, da = scd(x, y, alpha, w, mask, lam_n, sigma)
                da = da.clone()
                da[0, 0] = 1.0 - 2.0 * alpha[0, 0] - da[0, 0]
                return v, da
            return altered
        return scd

    def _watched(self, scd):
        """`scd` with its launches timed (CUDA events; the host clock on
        the CPU) and its inputs' shape and outputs kept."""
        torch, cuda = self.torch, self.device.type == "cuda"

        def watched(x, y, alpha, w, mask, lam_n, sigma):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                start = time.perf_counter()
            with torch.profiler.record_function("pb.scd_pass"):
                v, da = scd(x, y, alpha, w, mask, lam_n, sigma)
            if cuda:
                end.record()
            else:
                end = time.perf_counter()
            self.passes.append((start, end, tuple(x.shape), (v, da)))
            return v, da
        return watched

    def _iteration(self, *, window: bool) -> None:
        torch = self.torch
        store, solver = self.store, self.solver
        before = {"alpha": store.state["alpha"], "w": solver.w}
        done = self.engine.samples_processed
        solver.rng.shuffled.clear()
        self.passes.clear()
        t0 = time.perf_counter()
        with torch.profiler.record_function("pb.iteration"):
            hist = self.engine.run(1, solver.step, solver.metric)
        wall = time.perf_counter() - t0
        rec = hist[-1]
        start, end, shape, out = self.passes[-1]
        K, M, F = shape
        self.last = {"alpha": store.state["alpha"], "w": solver.w,
                     "gap": rec.metric}
        if not window:
            rec = {"K": K, "pools": [p.copy() for p in
                                     solver.rng.shuffled[-K:]],
                   "v": out[0], "da": out[1], "before": before,
                   "after": dict(self.last)}
            if len(self.checked) < self.tr["checked_steps"]:
                self.checked.append(rec)
            elif K not in {r["K"] for r in self.checked + self.replayed}:
                self.replayed.append(rec)
            return
        samples = self.engine.samples_processed - done
        self.rows_done += samples
        self.iters.append({"K": K, "M": M, "F": F, "wall_s": wall,
                           "samples": samples, "events": (start, end),
                           "gap": rec.metric})

    def step(self) -> None:
        self._iteration(window=True)

    # -- what the run reports ----------------------------------------------
    def end_to_end(self, window_s: float) -> Dict[str, float]:
        return {"glm_samples_per_s": self.rows_done / window_s}

    def _scd_times(self) -> None:
        """Each window iteration's SCD pass time from its events."""
        cuda = self.device.type == "cuda"
        for it in self.iters:
            s, e = it.pop("events", (None, None))
            if s is not None:
                it["scd_s"] = (s.elapsed_time(e) / 1e3 if cuda else e - s)

    def layer_context(self) -> Dict:
        cuda = self.device.type == "cuda"
        self._scd_times()
        return {"iterations": self.iters, "n_samples": self.c["n_samples"],
                "n_features": self.c["n_features"], "cuda": cuda}

    def attempted(self) -> int:
        return len(self.iters)

    def release(self) -> None:
        if hasattr(self, "real_pass"):
            self.ops.scd_local_pass = self.real_pass
        for name in ("solver", "engine", "store"):
            if hasattr(self, name):
                delattr(self, name)
        self.passes = []
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------
    def check(self, limits: Dict) -> List[Dict]:
        torch, c = self.torch, self.c
        from reference import glm_ref as ref
        X, y = pb_inputs.glm_rows(torch, c, self.seed, self.device)
        n, lam = c["n_samples"], c["lambda"]
        worst = dict(order=0.0, scd_v=0.0, scd_da=0.0, alpha=0.0, gap=0.0,
                     merge=0.0)
        # the reference follows the first iterations from the solver's start
        # (w = 0, alpha = 0) on its own state, in the visit order each
        # iteration took (itself checked) ...
        w_r = torch.zeros(c["n_features"], dtype=torch.float64,
                          device=self.device)
        a_r = np.zeros(n)
        for r in self.checked:
            w_r, a_r = self._follow(ref, X, y, r, w_r, a_r, worst)
        # ... and replays the first iteration at each other K from the
        # program's state before it
        for r in self.replayed:
            self._follow(ref, X, y, r, r["before"]["w"].double(),
                         np.asarray(r["before"]["alpha"], np.float64), worst)
        alpha = torch.from_numpy(np.asarray(self.last["alpha"])).to(
            self.device)
        w_dual = ref.primal_from_dual(torch, X, y, alpha, lam)
        dual = float((self.last["w"].double() - w_dual).norm()
                     / w_dual.norm().clamp_min(1e-300))
        del X, y
        self._scd_times()
        done = self.checked + self.replayed
        self.readings = {"checked_K": [r["K"] for r in done],
                         "merge": worst["merge"],
                         "gaps": [r["after"]["gap"] for r in done],
                         "window_gaps": [i["gap"] for i in self.iters[::16]],
                         "last_gap": self.last["gap"],
                         "window_iterations": len(self.iters),
                         "window_wall_s": sum(i["wall_s"]
                                              for i in self.iters),
                         "window_scd_s": sum(i["scd_s"]
                                             for i in self.iters)}
        return [{"name": k, "value": float(worst[k]), "limit": limits[k]}
                for k in ("order", "scd_v", "scd_da", "alpha", "gap")] + [
            {"name": "w_dual", "value": dual, "limit": limits["w_dual"]}]

    def _follow(self, ref, X, y, r: Dict, w_s, a_s: np.ndarray,
                worst: Dict):
        """One checked iteration `r` in the reference from the state
        (w_s, a_s): the worst gaps go into `worst`; returns the reference's
        state after it."""
        torch, c = self.torch, self.c
        n, lam = c["n_samples"], c["lambda"]
        K, pools = r["K"], r["pools"]
        worst["order"] += self._order_faults(pools, n, c["chunk_size"])
        M = max(max(len(p) for p in pools), 1)
        idx = np.zeros((K, M), np.int64)
        mask = np.zeros((K, M))
        for k, p in enumerate(pools):
            idx[k, :len(p)] = p
            mask[k, :len(p)] = 1.0
        idx_d = torch.from_numpy(idx).to(self.device)
        sigma = n / np.maximum(mask.sum(1), 1.0)
        v_ref, da_ref = ref.scd_pass(
            torch, lambda i0, i1: X[idx_d[:, i0:i1]], y.cpu().numpy()[idx],
            a_s[idx], w_s, mask, lam * n, sigma)
        sig_d = torch.from_numpy(sigma).to(self.device)
        v_p = r["v"].double()
        da_p = r["da"].double().cpu().numpy()
        move = (v_ref - w_s).norm(dim=1).clamp_min(1e-300)
        worst["scd_v"] = max(worst["scd_v"], float(
            ((v_p - v_ref).norm(dim=1) / move).max()))
        worst["scd_da"] = max(worst["scd_da"],
                              float(np.abs(da_p - da_ref).max()))
        # the merge, judged on the program's own pass
        w0p = r["before"]["w"].double()
        w_want = w0p + ((v_p - w0p) / sig_d[:, None]).sum(0)
        worst["merge"] = max(worst["merge"], float(
            (r["after"]["w"].double() - w_want).norm()
            / (w_want - w0p).norm().clamp_min(1e-300)))
        # the reference's own step
        w_n = w_s + ((v_ref - w_s) / sig_d[:, None]).sum(0)
        a_n = a_s.copy()
        for k in range(K):
            m = mask[k] > 0
            np.add.at(a_n, idx[k][m], da_ref[k][m])
        a_n = np.clip(a_n, 0.0, 1.0)
        worst["alpha"] = max(worst["alpha"], float(np.abs(
            np.asarray(r["after"]["alpha"], np.float64) - a_n).max()))
        g_ref, p_ref = ref.duality_gap(
            torch, X, y, torch.from_numpy(a_n).to(self.device), w_n, lam)
        worst["gap"] = max(worst["gap"],
                           abs(r["after"]["gap"] - g_ref) / p_ref)
        return w_n, a_n

    @staticmethod
    def _order_faults(pools, n: int, chunk: int) -> int:
        """Ways the visit order breaks CoCoA's partition: rows visited
        twice or never, and workers whose rows are not whole chunks."""
        rows = np.concatenate(pools)
        bad = int(len(rows) != n or
                  not np.array_equal(np.sort(rows), np.arange(n)))
        for p in pools:
            ids = np.unique(p // chunk)
            full = np.minimum((ids + 1) * chunk, n) - ids * chunk
            bad += int(len(p) != int(full.sum()))
        return bad
