"""The cluster orchestrator (`repro_torch.cluster`) against the JAX
package's (`repro.cluster`): every test of tests/test_cluster.py, each
run through both packages on the same inputs.

- Host-only tests (fair-share primitives, the allocator, the usage
  ledger, the pool, traces, the scaling policy) give equal outputs:
  allocations, credits, leases, migrations and JSON round trips.
- Orchestration tests run one trace through both packages.  The port's
  jobs run on the CPU (`device="cpu"`, a pool of CPU devices); each serve
  or LM job gets the JAX job's parameters, loaded in place into its
  engine's or trainer's module.  Timelines, preemptions, migrations,
  resizes, ticks, makespan, utilization, Jain fairness, `kv_moved_bytes`,
  token streams and every serve summary field are equal (the simulated
  clock drives TTFT and TPOT; only the JAX engine's compile-cache sizes
  are left out).  CoCoA gap curves match at rtol 1e-4 and w / alpha at
  atol 1e-5, as in tests/test_torch_train.py; the port's own solo and
  contended runs are bit-identical, as the reference asserts of its own.
- `test_lm_train_job_runs_real_steps_under_orchestration` fails on the
  reference itself (its loss rises over the 6 steps, ROADMAP C4): the
  mirror asserts the reference's timeline and losses, not that the loss
  falls.

The fault, observability, remesh, SLO-boost and disagg cluster tests are
in tests/test_torch_cluster_faults.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.cluster as JC
import repro.core as JCore
import repro.core.fairshare as JFS
import repro_torch.cluster as TC
import repro_torch.core as TCore
import repro_torch.core.fairshare as TFS
from repro.configs import TrainConfig, get_config, smoke_variant
from repro.data import make_lm_tokens
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.models import model as TM

CPU = torch.device("cpu")
# the JAX engine's compile-cache bookkeeping has no counterpart
NOT_COMPARED = {"jit_cache_sizes"}
GAP_RTOL = 1e-4
STATE_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The engines here run thousands of tiny CPU ops: one intra-op thread
    each keeps them from contending with the other test workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Side:
    """One package's cluster surface: the JAX package's or the port's
    (whose jobs run on the CPU and whose pool leases CPU devices)."""

    def __init__(self, port: bool):
        self.port = port
        self.C = TC if port else JC
        self.kw = dict(device="cpu") if port else {}
        arch = "smollm-360m"
        self.cfg = (t_smoke_variant(t_get_config(arch)) if port
                    else smoke_variant(get_config(arch)))

    def pool(self, n, **kw):
        if self.port:
            kw["devices"] = [CPU]
        return self.C.DevicePool(n, **kw)

    def trainer(self, name, seed=0, iterations=6, mode="microtask", **kw):
        """tests/test_cluster.py's `_tiny_trainer`."""
        return self.C.cocoa_train_job(name, iterations=iterations, k_tasks=4,
                                      n=400, f=8, chunk=20, seed=seed,
                                      mode=mode, **kw, **self.kw)

    def serve(self, spec, **kw):
        return self.C.ServeJob(self.C.JobSpec(**spec), self.cfg, **kw,
                               **self.kw)

    def disagg(self, spec, **kw):
        return self.C.DisaggServeJob(self.C.JobSpec(**spec), self.cfg, **kw,
                                     **self.kw)


JAX, PORT = Side(False), Side(True)
SIDES = (JAX, PORT)


# ---------------------------------------------------------------------------
# carrying the JAX jobs' parameters into the port's
# ---------------------------------------------------------------------------


def _params(job):
    """The parameters a serve or LM job computes with: the JAX tree or the
    port's module."""
    if hasattr(job, "trainer"):
        return job.trainer.params
    eng = job.engine
    return eng.prefill.params if hasattr(eng, "prefill") else eng.params


def carry(jax_jobs, port_jobs):
    """Load each JAX serve/LM job's parameters into the port job of the
    same name, in place (the module and its storage stay the engine's or
    trainer's own; a disagg engine's halves share the one module)."""
    by_name = {j.spec.name: j for j in jax_jobs}
    for tj in port_jobs:
        if not isinstance(tj, (TC.ServeJob, TC.LMTrainJob)):
            continue
        mod = _params(tj)
        ptrs = {k: v.data_ptr() for k, v in mod.state_dict().items()}
        src = TM.params_from_numpy(
            mod.cfg, jax.tree.map(np.asarray, _params(by_name[tj.spec.name])),
            device="cpu")
        mod.load_state_dict(src.state_dict())
        assert {k: v.data_ptr() for k, v in mod.state_dict().items()} == ptrs
        if isinstance(tj, TC.DisaggServeJob):
            assert tj.engine.decode.params is mod


def run_both(build, *, run=None):
    """`build(side)` -> (orchestrator, jobs) for one package; the JAX side
    is built first, the port's jobs get its parameters, both run (by
    `run(orch)`, default `orch.run()`).  -> {side: (report, jobs by name,
    orchestrator)}."""
    out = {}
    built = {s: build(s) for s in SIDES}
    carry(built[JAX][1], built[PORT][1])
    for s in SIDES:
        orch, jobs = built[s]
        rep = run(orch) if run is not None else orch.run()
        out[s] = (rep, {j.spec.name: j for j in jobs}, orch)
    return out


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def streams(metrics):
    return {r.rid: list(r.generated) for r in metrics.requests}


def _serve_summary(s):
    out = {k: v for k, v in s.items() if k not in NOT_COMPARED}
    if "disagg" in out:
        out["disagg"] = {k: ({kk: vv for kk, vv in v.items()
                              if kk not in NOT_COMPARED}
                             if isinstance(v, dict) else v)
                         for k, v in out["disagg"].items()}
    return out


def assert_same_job_summary(js, ts):
    assert set(js) == set(ts)
    for k in js:
        if k in ("final_metric", "final_loss") and js[k] is not None:
            np.testing.assert_allclose(ts[k], js[k], rtol=GAP_RTOL)
        elif k == "serve":
            assert _serve_summary(ts[k]) == _serve_summary(js[k]), k
        else:
            assert ts[k] == js[k], (k, ts[k], js[k])


def assert_same_history(jh, th):
    """Engine iteration records: equal but for the metric (the gap, held
    at rtol 1e-4)."""
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        ma, mb = da.pop("metric"), db.pop("metric")
        assert da == db
        if ma is None:
            assert mb is None
        else:
            np.testing.assert_allclose(mb, ma, rtol=GAP_RTOL)


def assert_same_job(jj, tj):
    assert tj.state.value == jj.state.value
    assert (tj.preemptions, tj.resizes, tj.node_time, tj.presence_time) \
        == (jj.preemptions, jj.resizes, jj.node_time, jj.presence_time)
    if hasattr(jj, "solver"):
        assert_same_history(jj.history, tj.history)
        np.testing.assert_allclose(tj.solver.store.state["alpha"],
                                   np.asarray(jj.solver.store.state["alpha"]),
                                   atol=STATE_ATOL)
        np.testing.assert_allclose(tj.solver.w.numpy(),
                                   np.asarray(jj.solver.w), atol=STATE_ATOL)
    if isinstance(jj, JC.ServeJob):
        assert streams(tj.engine.metrics) == streams(jj.engine.metrics)
        assert tj.kv_moved_bytes == jj.kv_moved_bytes
    if hasattr(jj, "trainer"):
        assert tj.steps_done == jj.steps_done
        np.testing.assert_allclose(tj.loss_curve(), jj.loss_curve(),
                                   rtol=GAP_RTOL)


def assert_same_report(jr, tr):
    assert [dataclasses.asdict(t) for t in tr.timeline] \
        == [dataclasses.asdict(t) for t in jr.timeline]
    for f in ("makespan", "utilization", "fairness_jain", "preemptions",
              "migrations", "ticks", "kv_moved_bytes", "node_failures",
              "recoveries", "retries", "shed_requests", "recovery_ticks"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert set(tr.jobs) == set(jr.jobs)
    for name in jr.jobs:
        assert_same_job_summary(jr.jobs[name], tr.jobs[name])


def assert_same_run(out):
    (jr, jj, _), (tr, tj, _) = out[JAX], out[PORT]
    assert_same_report(jr, tr)
    for name in jj:
        assert_same_job(jj[name], tj[name])


# ---------------------------------------------------------------------------
# fair-share primitives + allocator
# ---------------------------------------------------------------------------


def _check_alloc_invariants(pool, demands, alloc):
    total_demand = sum(d.demand for d in demands)
    assert sum(alloc.values()) <= pool
    assert sum(alloc.values()) == min(pool, total_demand)  # work conserving
    for d in demands:
        assert 0 <= alloc[d.name] <= d.demand
    demanding = [d for d in demands if d.demand > 0]
    if len(demanding) <= pool:
        for d in demanding:  # no starvation under positive weights
            assert alloc[d.name] >= 1, f"{d.name} starved: {alloc}"


def _allocate_both(pool, demands, credit=None, **kw):
    """One demand vector through both allocators: equal allocations.
    `demands`: (name, demand, weight, priority) tuples."""
    outs = []
    for s in SIDES:
        jds = [s.C.JobDemand(*d) for d in demands]
        outs.append(s.C.FairShareAllocator(**kw).allocate(pool, jds,
                                                          credit=credit))
    assert outs[0] == outs[1]
    return outs[1], [PORT.C.JobDemand(*d) for d in demands]


def test_weighted_max_min_proportional_and_capped():
    for fs in (JFS, TFS):
        assert fs.weighted_max_min(6, [10, 10], [2, 1]) == [4.0, 2.0]
        assert fs.weighted_max_min(8, [8, 8, 4], [1, 1, 4]) \
            == [2.0, 2.0, 4.0]
        assert fs.weighted_max_min(100, [3, 5], [1, 1]) == [3.0, 5.0]
        with pytest.raises(ValueError):
            fs.weighted_max_min(4, [1, 1], [1, 0])
    rng = np.random.default_rng(0)
    for _ in range(50):
        n = int(rng.integers(1, 6))
        cap, dem = float(rng.integers(0, 20)), rng.integers(0, 9, n).tolist()
        w = rng.uniform(0.1, 5.0, n).tolist()
        assert TFS.weighted_max_min(cap, dem, w) \
            == JFS.weighted_max_min(cap, dem, w)


def test_integerize_preserves_total_and_caps():
    for fs in (JFS, TFS):
        out = fs.integerize_shares([2.5, 2.5, 3.0], [8, 8, 3], 8)
        assert sum(out) == 8 and out[2] == 3
    assert TFS.integerize_shares([1.2, 3.3, 2.5], [4, 4, 4], 7,
                                 prefer=[1.0, 2.0, 3.0]) \
        == JFS.integerize_shares([1.2, 3.3, 2.5], [4, 4, 4], 7,
                                 prefer=[1.0, 2.0, 3.0])


def test_jain_index_bounds():
    for fs in (JFS, TFS):
        assert fs.jain_index([1, 1, 1]) == pytest.approx(1.0)
        assert fs.jain_index([1, 0, 0]) == pytest.approx(1 / 3)
        assert fs.jain_index([]) == 1.0
    x = [0.3, 1.7, 2.2, 0.0]
    assert TFS.jain_index(x) == JFS.jain_index(x)


def test_stride_pick_is_weighted():
    got = []
    for fs in (JFS, TFS):
        served, picks = {}, []
        for _ in range(8):
            t = fs.stride_pick(served, {"a": 3.0, "b": 1.0}, ["a", "b"])
            served[t] = served.get(t, 0.0) + 1.0
            picks.append(t)
        assert picks.count("a") == 6 and picks.count("b") == 2
        got.append(picks)
    assert got[0] == got[1]


def test_allocator_contention_shares():
    demands = [("a", 8, 1, 0), ("b", 8, 1, 0), ("s", 4, 2, 1)]
    alloc, jds = _allocate_both(8, demands, priority_boost=2.0)
    assert alloc == {"a": 2, "b": 2, "s": 4}  # priority preempts, capped
    _check_alloc_invariants(8, jds, alloc)


def test_allocator_no_starvation_with_tiny_weight():
    demands = [("big", 8, 1000.0, 2), ("tiny", 8, 0.001, 0)]
    alloc, jds = _allocate_both(4, demands)
    _check_alloc_invariants(4, jds, alloc)
    assert alloc["tiny"] >= 1


def test_allocator_zero_demand_and_empty():
    for s in SIDES:
        al = s.C.FairShareAllocator()
        assert al.allocate(8, []) == {}
        with pytest.raises(ValueError):
            al.allocate(8, [s.C.JobDemand("bad", 2, weight=0.0)])
    alloc, _ = _allocate_both(8, [("idle", 0), ("busy", 3)])
    assert alloc == {"idle": 0, "busy": 3}


def test_allocator_property_invariants_seeded():
    """Pure-numpy fuzz: both allocators give one allocation, and it keeps
    every invariant."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        pool = int(rng.integers(0, 17))
        njobs = int(rng.integers(1, 7))
        demands = [(f"j{i}", int(rng.integers(0, 13)),
                    float(rng.uniform(0.05, 8.0)), int(rng.integers(0, 3)))
                   for i in range(njobs)]
        alloc, jds = _allocate_both(pool, demands)
        _check_alloc_invariants(pool, jds, alloc)


try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(
        pool=st.integers(0, 24),
        demands=st.lists(
            st.tuples(st.integers(0, 16),
                      st.floats(0.01, 10.0, allow_nan=False),
                      st.integers(0, 3)),
            min_size=1, max_size=8),
    )
    def test_allocator_property_invariants(pool, demands):
        alloc, jds = _allocate_both(
            pool, [(f"j{i}", d, w, p) for i, (d, w, p) in enumerate(demands)])
        _check_alloc_invariants(pool, jds, alloc)
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_allocator_property_invariants():
        pass


# ---------------------------------------------------------------------------
# device pool
# ---------------------------------------------------------------------------


def test_pool_minimal_churn_reassign():
    got = []
    for s in SIDES:
        pool = s.pool(6, pst=[1.0, 1.0, 1.0, 1.0, 1.5, 1.5])
        first = pool.reassign({"a": 4, "b": 2})
        assert sorted(first["a"] + first["b"]) == list(range(6))
        held_a = set(first["a"])
        second = pool.reassign({"a": 3, "b": 3})
        assert set(second["a"]) < held_a
        surrendered = held_a - set(second["a"])
        assert all(pool.pst[n] == max(pool.psts_of(list(held_a)))
                   for n in surrendered)
        pool.release_all("b")
        assert pool.n_leased() == len(second["a"])
        third = pool.reassign({"a": 2, "c": 4})
        got.append((first, second, third, pool.migrations,
                    pool.free_nodes()))
    assert got[0] == got[1]
    assert PORT.pool(3).devices == [CPU] * 3


def test_pool_rejects_overcommit():
    for s in SIDES:
        pool = s.pool(4)
        with pytest.raises(ValueError):
            pool.reassign({"a": 3, "b": 2})


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


def test_trace_json_roundtrip_and_order():
    texts = []
    for s in SIDES:
        C = s.C
        tr = C.ClusterTrace([C.depart(9.0, "t"), C.arrive(0.0, "t"),
                             C.burst(4.0, "s", 8, rate=2.0, tenant="gold")])
        assert [e.kind for e in tr.events] == ["arrive", "burst", "depart"]
        tr2 = C.ClusterTrace.from_json(tr.to_json())
        assert [e.to_dict() for e in tr2.events] == [e.to_dict()
                                                    for e in tr.events]
        assert tr2.events[1].payload["tenant"] == "gold"
        assert tr2.pop_due(4.0) == tr2.events[:2]
        assert not tr2.exhausted and tr2.last_event_time("t") == 9.0
        with pytest.raises(ValueError):
            C.TraceEvent(0.0, "resize", "t")
        texts.append(tr.to_json())
    assert texts[0] == texts[1]
    # each package reads the other's trace
    assert TC.ClusterTrace.from_json(texts[0]).to_json() == texts[0]
    assert JC.ClusterTrace.from_json(texts[1]).to_json() == texts[1]


def test_trace_add_after_consumption_never_replays():
    for s in SIDES:
        C = s.C
        tr = C.ClusterTrace([C.arrive(0.0, "a"), C.depart(10.0, "a")])
        assert [e.kind for e in tr.pop_due(1.0)] == ["arrive"]
        tr.add(C.burst(5.0, "s", 2))
        tr.add(C.TraceEvent(0.5, "burst", "s", {"n": 1}))
        due = tr.pop_due(6.0)
        assert [e.at for e in due] == [0.5, 5.0]
        assert [e.kind for e in tr.pop_due(11.0)] == ["depart"]
        assert tr.exhausted


# ---------------------------------------------------------------------------
# ElasticScalingPolicy: no-op guard, callable schedule, decision logging
# ---------------------------------------------------------------------------


def test_scaling_policy_rejects_noop_construction():
    for core in (JCore, TCore):
        with pytest.raises(ValueError, match="never fires"):
            core.ElasticScalingPolicy([])
        with pytest.raises(ValueError, match="never fires"):
            core.ElasticScalingPolicy(None)


def test_scaling_policy_callable_schedule_and_event_log():
    hists = []
    for core in (JCore, TCore):
        store = core.ChunkStore({"x": np.zeros((40, 2), np.float32)},
                                chunk_size=5)
        a = core.Assignment(store.n_chunks, 2, np.random.default_rng(0))
        targets = iter([None, 4, 4, 1])
        pol = core.ElasticScalingPolicy(lambda t: next(targets))
        eng = core.UniTaskEngine(store, a, [pol], seed=0)

        def solver(s, asg, sh):
            k = asg.n_workers
            return {"samples_processed": 40, "per_worker_samples": [40 / k] * k}

        hist = eng.run(4, solver, lambda: 0.0)
        assert [r.n_workers for r in hist] == [2, 4, 4, 1]
        assert hist[0].events == []
        assert hist[1].events == [(hist[0].sim_time, 2, 4)]
        assert hist[2].events == []
        assert hist[3].events[0][1:] == (4, 1)
        hists.append([dataclasses.asdict(r) for r in hist])
    assert hists[0] == hists[1]


# ---------------------------------------------------------------------------
# jobs + orchestrator end-to-end
# ---------------------------------------------------------------------------


def test_orchestrator_contention_preempts_without_perturbing_loss():
    def build(s):
        C = s.C
        t1 = s.trainer("t1", seed=0)
        srv = s.serve(dict(name="svc", kind="serve", weight=1.0, priority=1,
                           max_nodes=2),
                      capacity=4, cache_len=32, prefill_bucket=8, seed=0)
        trace = C.ClusterTrace([
            C.arrive(0.0, "t1"), C.arrive(2.0, "svc"),
            C.burst(2.0, "svc", 4, prompt_len=[6, 10], max_new_tokens=[3, 5],
                    seed=1),
        ])
        return C.ClusterOrchestrator(s.pool(4), [t1, srv], trace, dt=1.0,
                                     max_ticks=300), [t1, srv]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    assert rep.jobs["t1"]["state"] == "finished"
    assert rep.jobs["svc"]["state"] == "finished"
    assert rep.preemptions >= 1
    assert rep.jobs["svc"]["serve"]["requests_finished"] == 4
    assert 0.0 < rep.utilization <= 1.0
    assert 0.0 < rep.fairness_jain <= 1.0

    # Chicle headline, in the port: contention changed WHEN iterations
    # ran, not WHAT they computed — solo and contended are bit-identical
    t1 = jobs["t1"]
    solo = PORT.trainer("solo", seed=0)
    TC.ClusterOrchestrator(PORT.pool(4), [solo],
                           TC.ClusterTrace([TC.arrive(0.0, "solo")]),
                           dt=1.0, max_ticks=300).run()
    assert solo.loss_curve() == t1.loss_curve()
    assert np.array_equal(solo.solver.store.state["alpha"],
                          t1.solver.store.state["alpha"])
    assert torch.equal(solo.solver.w, t1.solver.w)


def test_orchestrator_departure_returns_nodes():
    def build(s):
        C = s.C
        t1 = s.trainer("t1", seed=0, iterations=40)
        t2 = s.trainer("t2", seed=1, iterations=40, mode="unitask")
        trace = C.ClusterTrace([C.arrive(0.0, "t1"), C.arrive(0.0, "t2"),
                                C.depart(4.0, "t2")])
        return C.ClusterOrchestrator(s.pool(4), [t1, t2], trace, dt=1.0,
                                     max_ticks=200), [t1, t2]

    out = run_both(build)
    assert_same_run(out)
    rep = out[PORT][0]
    assert rep.jobs["t2"]["state"] == "departed"
    assert rep.jobs["t1"]["state"] == "finished"
    post = [t for t in rep.timeline if t.t >= 4.0 and t.alloc.get("t1")]
    assert post and all(t.alloc["t1"] == 4 for t in post)


def test_lm_train_job_runs_real_steps_under_orchestration():
    """Real-compute LM job in both packages: the orchestrator drives real
    train steps, scale-to-zero parks state on host, and the job finishes.
    The reference asserts a falling loss, which its own run does not give
    (6 steps on a smoke model, ROADMAP C4); the mirror holds the port to
    the reference's timeline and losses instead."""
    data = make_lm_tokens(32, 32, JAX.cfg.vocab_size, seed=0)

    def batch(i):
        sl = slice(4 * (i % 8), 4 * (i % 8 + 1))
        return {"tokens": data["tokens"][sl], "labels": data["labels"][sl],
                "weights": np.ones((4,), np.float32)}

    def build(s):
        C = s.C
        tc = (TTrainConfig if s.port else TrainConfig)(
            learning_rate=5e-3, remat=False)
        job = C.LMTrainJob(C.JobSpec("lm", "train", max_nodes=2), s.cfg, tc,
                           batch_fn=batch, steps=6, step_time=1.0, seed=0,
                           **s.kw)
        hog = s.trainer("hog", seed=0, iterations=3)
        hog.spec.priority = 2
        trace = C.ClusterTrace([C.arrive(0.0, "lm"), C.arrive(2.0, "hog")])
        return C.ClusterOrchestrator(s.pool(1), [job, hog], trace, dt=1.0,
                                     max_ticks=100), [job, hog]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    job = jobs["lm"]
    assert rep.jobs["lm"]["state"] == "finished"
    assert job.steps_done == 6
    assert rep.jobs["lm"]["steps_done"] == 6
    assert job.preemptions >= 1  # the hog displaced it entirely
    assert not job.trainer.suspended and job.trainer.k == 1
    assert all(np.isfinite(job.loss_curve()))


def test_serve_job_scale_to_zero_and_resume():
    def build(s):
        C = s.C
        srv = s.serve(dict(name="svc", kind="serve", weight=1.0,
                           max_nodes=2),
                      capacity=4, cache_len=32, prefill_bucket=8, seed=0)
        hog = s.trainer("hog", seed=0, iterations=6)
        hog.spec.priority = 2
        hog.spec.weight = 50.0
        trace = C.ClusterTrace([
            C.arrive(0.0, "hog"), C.arrive(0.0, "svc"),
            C.burst(0.0, "svc", 3, prompt_len=[6, 8], max_new_tokens=[3, 4],
                    seed=1),
        ])
        return C.ClusterOrchestrator(s.pool(1), [hog, srv], trace, dt=1.0,
                                     max_ticks=300), [hog, srv]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    srv = jobs["svc"]
    events = [e[1] for e in srv.engine.metrics.suspend_events]
    assert "suspend" in events and "resume" in events
    assert srv.engine.metrics.suspend_events \
        == out[JAX][1]["svc"].engine.metrics.suspend_events
    assert rep.jobs["svc"]["serve"]["requests_finished"] == 3
    assert rep.jobs["svc"]["state"] == "finished"


def test_serve_job_without_bursts_retires_instead_of_spinning():
    def build(s):
        C = s.C
        srv = s.serve(dict(name="svc", kind="serve", max_nodes=2),
                      capacity=2, cache_len=32, seed=0)
        return C.ClusterOrchestrator(s.pool(2), [srv],
                                     C.ClusterTrace([C.arrive(0.0, "svc")]),
                                     dt=1.0, max_ticks=50), [srv]

    out = run_both(build)
    assert_same_run(out)
    rep = out[PORT][0]
    assert rep.jobs["svc"]["state"] == "finished"
    assert rep.ticks < 5


def test_suspended_engine_refuses_to_tick():
    for s in SIDES:
        srv = s.serve(dict(name="svc", kind="serve"), capacity=2,
                      cache_len=32, seed=0)
        srv.engine.suspend()
        with pytest.raises(RuntimeError, match="suspended"):
            srv.engine.tick()
        srv.engine.resume()
        srv.engine.tick()  # legal again


def test_engine_with_clock_rejects_wall_clock_run():
    for s in SIDES:
        srv = s.serve(dict(name="svc", kind="serve"), capacity=2,
                      cache_len=32, seed=0)
        with pytest.raises(ValueError, match="tick"):
            srv.engine.run([])


# ---------------------------------------------------------------------------
# allocator lookahead: time-decayed usage credit
# ---------------------------------------------------------------------------


def test_usage_ledger_credit_bounds_and_forget():
    snaps = []
    for s in SIDES:
        C = s.C
        led = C.UsageLedger(half_life=4.0, credit_cap=4.0)
        assert led.credit("unknown") == 1.0
        demands = [C.JobDemand("hog", 4), C.JobDemand("meek", 4)]
        for _ in range(20):
            led.update({"hog": 4, "meek": 0}, demands, 1.0)
        assert led.credit("hog") < 1.0
        assert led.credit("meek") == 4.0
        assert 1.0 / 4.0 <= led.credit("hog")
        snaps.append(led.snapshot())
        led.forget("hog")
        assert led.credit("hog") == 1.0
        with pytest.raises(ValueError):
            C.UsageLedger(half_life=0.0)
        with pytest.raises(ValueError):
            C.UsageLedger(credit_cap=1.0)
    assert snaps[0] == snaps[1]


def _ledger_run(C, ticks, demands_at, half_life):
    al, led = C.FairShareAllocator(), C.UsageLedger(half_life=half_life)
    allocs = []
    for t in range(ticks):
        demands = demands_at(C, t)
        alloc = al.allocate(8, demands, credit=led.snapshot())
        led.update(alloc, demands, 1.0)
        allocs.append(alloc)
    return allocs, led


def test_usage_ledger_burst_repayment():
    def burst_demands(C, t):
        pa = 1 if t < 15 else 0
        return [C.JobDemand("a", 8, 1.0, pa), C.JobDemand("b", 8, 1.0, 0)]

    def solo(C, t):
        return [C.JobDemand("solo", 8, 1.0)]

    def pair(C, t):
        return [C.JobDemand("small", 1, 1.0), C.JobDemand("big", 8, 1.0)]

    runs = {}
    for s in SIDES:
        runs[s] = [(allocs, led.snapshot()) for allocs, led in (
            _ledger_run(s.C, 60, burst_demands, 6.0),
            _ledger_run(s.C, 10, solo, 6.0),
            _ledger_run(s.C, 20, pair, 6.0))]
    assert runs[JAX] == runs[PORT]
    (allocs, _), (_, solo_c), (_, pair_c) = runs[PORT]
    alloc_b = [a["b"] for a in allocs[15:]]
    assert alloc_b[0] > 4
    assert alloc_b[-1] == 4
    assert min(8 - b for b in alloc_b) >= 1
    assert solo_c["solo"] == pytest.approx(1.0)
    assert pair_c["big"] == pytest.approx(1.0)
    assert pair_c["small"] == pytest.approx(1.0)


def test_usage_ledger_long_run_shares_respect_weights():
    results = []
    for s in SIDES:
        C = s.C
        rng = np.random.default_rng(5)
        al = C.FairShareAllocator()
        led = C.UsageLedger(half_life=8.0)
        total = {"a": 0.0, "b": 0.0}
        allocs = []
        for _ in range(400):
            demands = [C.JobDemand("a", 8, 1.0), C.JobDemand("b", 8, 3.0)]
            if rng.random() < 0.4:
                demands.append(C.JobDemand("c", int(rng.integers(1, 9)),
                                           1.0))
            alloc = al.allocate(8, demands, credit=led.snapshot())
            _check_alloc_invariants(8, demands, alloc)
            led.update(alloc, demands, 1.0)
            total["a"] += alloc["a"]
            total["b"] += alloc["b"]
            allocs.append(alloc)
        ratio = total["b"] / total["a"]
        assert 2.5 <= ratio <= 3.5, f"long-run share ratio drifted: {ratio}"
        results.append((allocs, led.snapshot()))
    assert results[0] == results[1]


def test_orchestrator_with_ledger_matches_invariants():
    def build(s):
        C = s.C
        t1 = s.trainer("t1", seed=0)
        t2 = s.trainer("t2", seed=1)
        trace = C.ClusterTrace([C.arrive(0.0, "t1"), C.arrive(3.0, "t2")])
        return C.ClusterOrchestrator(s.pool(4), [t1, t2], trace,
                                     usage_half_life=6.0, dt=1.0,
                                     max_ticks=200), [t1, t2]

    out = run_both(build)
    assert_same_run(out)
    rep, _, orch = out[PORT]
    assert rep.jobs["t1"]["state"] == "finished"
    assert rep.jobs["t2"]["state"] == "finished"
    assert orch.ledger is not None
    assert orch.ledger.snapshot() == out[JAX][2].ledger.snapshot()


# ---------------------------------------------------------------------------
# lease shrink parks serve slots (page-granular preemption, bytes charged)
# ---------------------------------------------------------------------------


def test_serve_lease_shrink_parks_slots_and_charges_bytes():
    def build(s):
        C = s.C
        srv = s.serve(dict(name="svc", kind="serve", weight=1.0,
                           max_nodes=3),
                      capacity=6, cache_len=40, prefill_bucket=8,
                      slots_per_node=2, ticks_per_dt=1.0, kv_layout="paged",
                      seed=0)
        hog = s.trainer("hog", seed=0, iterations=8)
        hog.spec.priority = 2
        hog.spec.weight = 20.0
        hog.spec.max_nodes = 2
        trace = C.ClusterTrace([
            C.arrive(0.0, "svc"),
            C.burst(0.0, "svc", 6, prompt_len=[6, 8],
                    max_new_tokens=[20, 24], seed=1),
            C.arrive(1.0, "hog"),
        ])
        return C.ClusterOrchestrator(s.pool(3), [srv, hog], trace, dt=1.0,
                                     max_ticks=400), [srv, hog]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    srv = jobs["svc"]
    assert rep.jobs["svc"]["state"] == "finished"
    assert srv.kv_moved_bytes > 0
    assert rep.kv_moved_bytes == srv.kv_moved_bytes
    assert rep.jobs["svc"]["kv_moved_bytes"] == srv.kv_moved_bytes
    assert srv.kv_moved_bytes == int(
        srv.engine.mem.stats()["park_bytes"]
        + srv.engine.mem.stats()["restore_bytes"])
    s = rep.jobs["svc"]["serve"]
    assert s["parked_total"] >= 1 and s["restored_total"] >= 1
    assert s["requests_finished"] == 6
    assert srv.engine.pages.n_used == 0 and srv.engine.mem.n_parked == 0
