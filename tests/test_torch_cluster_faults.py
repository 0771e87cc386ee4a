"""The cluster tests outside tests/test_cluster.py, in the port against
the JAX package: node failures, checkpoint rollback, lease revocation and
the orchestrator's context manager (tests/test_faults.py:254, :277, :308,
:321), the allocator's SLO boost (tests/test_overload.py:457), the
cluster trace stream (tests/test_obs.py:252), suspend/resume through
`cocoa_train_job` (tests/test_elastic_remesh.py:67) and the disagg serve
job (tests/test_disagg.py:268), plus an LM job's checkpoint rollback.

Both packages run one trace (`run_both` and the comparisons of
tests/test_torch_cluster.py: equal timelines, reports, streams and serve
summaries; CoCoA gaps at rtol 1e-4, w / alpha at atol 1e-5; LM losses at
rtol 1e-4).  `QueueSplitPolicy`'s backlog mode weighs each pool's backlog
by its host tick-time EMA, a wall-clock reading, so the reference's disagg
test under it runs on the port alone with the reference's assertions;
the cross-package disagg run uses `ScheduledSplitPolicy`, whose decisions
read no wall time, with a lease change."""
import json

import jax
import numpy as np
import pytest
import torch

import repro_torch.cluster as TC
from repro.configs import TrainConfig
from repro.data import make_lm_tokens
from repro.models import model as JM
from repro.obs import Tracer as JTracer
from repro.serve import ScheduledSplitPolicy as JScheduledSplitPolicy
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.launch.elastic import ElasticTrainer
from repro_torch.models import model as TM
from repro_torch.obs import Tracer as TTracer
from repro_torch.serve import QueueSplitPolicy as TQueueSplitPolicy
from repro_torch.serve import ScheduledSplitPolicy as TScheduledSplitPolicy

from test_torch_cluster import (JAX, PORT, SIDES,  # noqa: F401
                                _one_torch_thread, assert_same_job,
                                assert_same_run, run_both)


def _trainer(s, name="t", **kw):
    return s.C.cocoa_train_job(name, **kw, **s.kw)


# ---------------------------------------------------------------------------
# tests/test_faults.py: node failures, checkpoint rollback, report columns
# ---------------------------------------------------------------------------


def test_train_job_checkpoint_rollback(tmp_path):
    jobs = {}
    for s in SIDES:
        d = tmp_path / ("port" if s.port else "jax")
        job = _trainer(s, iterations=8, k_tasks=2, n=200, f=8, chunk=25,
                       ckpt_dir=str(d), ckpt_every=2)
        job.arrive(0.0)
        job.on_allocation([0, 1], [1.0, 1.0], 0.0)
        while job.iterations_done < 5:
            job.advance(0.2, 0.0)
        done = job.iterations_done
        w_snap = None
        if s.port:  # the w the last snapshot holds, to check the restore
            w_snap = np.load(d / f"ckpt_{(done // 2) * 2:08d}.npz")[
                "params/w"]
        job.on_node_failure(1.0)
        last_snap = (done // 2) * 2
        assert job.iterations_done == last_snap
        assert job.recoveries == 1
        assert job.recovery_ticks == done - last_snap
        assert len(job.engine.history) == last_snap
        if s.port:  # w back on the solver's device, fp32, exactly
            w = job.solver.w
            assert w.dtype == torch.float32
            assert w.device == job.solver.device
            assert np.array_equal(w.numpy(), w_snap)
        while job.iterations_done < 8:
            job.advance(1.0, 2.0)
        assert job.state.value == "finished"
        sm = job.summary()
        assert sm["recoveries"] == 1 and sm["node_failures"] == 1
        jobs[s] = (job, done, sm)
    (jj, jdone, jsum), (tj, tdone, tsum) = jobs[JAX], jobs[PORT]
    assert tdone == jdone
    assert_same_job(jj, tj)
    np.testing.assert_allclose(tsum.pop("final_metric"),
                               jsum.pop("final_metric"), rtol=1e-4)
    assert tsum == jsum


def test_cluster_fail_and_slow_events_route_and_report():
    def build(s):
        C = s.C
        sj = s.serve(dict(name="svc", kind="serve", max_nodes=2),
                     capacity=4, cache_len=32, kv_layout="paged",
                     page_size=8)
        trace = C.ClusterTrace([
            C.arrive(0.0, "svc"),
            C.burst(1.0, "svc", 6, seed=1),
            C.slow(2.0, 0, 2.0),
            C.fail(3.0, node=1),
        ])
        pool = s.pool(3)
        return C.ClusterOrchestrator(pool, [sj], trace, max_ticks=300), [sj]

    def run(orch):
        with orch:
            return orch.run()

    out = run_both(build, run=run)
    assert_same_run(out)
    rep, jobs, orch = out[PORT]
    pool = orch.pool
    assert rep.node_failures == 1
    assert pool.dead == {1} and pool.n_alive == 2
    assert pool.pst[0] == 2.0
    assert np.array_equal(pool.pst, out[JAX][2].pool.pst)
    assert all(t.nodes_used <= 2 for t in rep.timeline if t.t >= 3.0)
    js = rep.jobs["svc"]
    assert js["state"] == "finished"
    assert js["serve"]["requests_finished"] == 6
    # node 1 was leased to svc when it died: the crash path ran (in both)
    assert js["node_failures"] == 1 and js["recoveries"] >= 1
    assert rep.recoveries >= 1
    assert jobs["svc"].engine.metrics.fault_events \
        == out[JAX][1]["svc"].engine.metrics.fault_events
    d = rep.to_dict()
    for col in ("node_failures", "recoveries", "retries", "shed_requests",
                "recovery_ticks"):
        assert col in d


def test_cluster_lease_revocation_keeps_state():
    def build(s):
        C = s.C
        job = _trainer(s, iterations=6, k_tasks=2, n=200, f=8, chunk=25)
        trace = C.ClusterTrace([C.arrive(0.0, "t"), C.fail(2.0, "t")])
        return C.ClusterOrchestrator(s.pool(2), [job], trace,
                                     max_ticks=200), [job]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    assert rep.jobs["t"]["state"] == "finished"
    assert rep.jobs["t"]["iterations_done"] == 6
    assert jobs["t"].preemptions >= 1
    assert rep.node_failures == 0


def test_orchestrator_context_manager_closes_trace_on_raise(tmp_path):
    texts = []
    for s in SIDES:
        C = s.C
        job = _trainer(s, iterations=4, k_tasks=2, n=100, f=8, chunk=25)
        trace = C.ClusterTrace([C.arrive(0.0, "t")])
        out = str(tmp_path / f"ticks_{int(s.port)}.jsonl")
        with pytest.raises(RuntimeError, match="boom"):
            with C.ClusterOrchestrator(s.pool(2), [job], trace,
                                       trace_out=out) as orch:
                orch.step()
                assert orch._trace_fh is not None
                raise RuntimeError("boom")
        assert orch._trace_fh is None  # __exit__ closed the stream
        text = open(out).read()
        assert text.count("\n") == 1
        texts.append(text)
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# tests/test_overload.py: the allocator's SLO boost
# ---------------------------------------------------------------------------


def test_allocator_slo_boost():
    outs = []
    for s in SIDES:
        C = s.C
        alloc = C.FairShareAllocator(slo_boost=2.0)
        assert alloc.effective_weight(C.JobDemand("j", 4)) == 1.0
        assert alloc.effective_weight(
            C.JobDemand("j", 4, attainment=1.0)) == 1.0
        assert alloc.effective_weight(
            C.JobDemand("j", 4, attainment=0.0)) == 2.0
        assert alloc.effective_weight(
            C.JobDemand("j", 4, attainment=0.5)) == pytest.approx(1.5)
        assert alloc.effective_weight(
            C.JobDemand("j", 4, attainment=7.0)) == 1.0
        out = alloc.allocate(8, [C.JobDemand("miss", 8, attainment=0.0),
                                 C.JobDemand("meet", 8, attainment=1.0)])
        assert out["miss"] > out["meet"]
        with pytest.raises(ValueError):
            C.FairShareAllocator(slo_boost=0.5)
        rng = np.random.default_rng(7)
        for _ in range(50):
            ds = [C.JobDemand(f"j{i}", int(rng.integers(0, 9)),
                              float(rng.uniform(0.1, 4.0)),
                              int(rng.integers(0, 2)),
                              attainment=(None if rng.random() < 0.3
                                          else float(rng.uniform(-0.5, 1.5))))
                  for i in range(4)]
            out.update({f"r{len(out)}": alloc.allocate(8, ds)})
        outs.append(out)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# tests/test_obs.py: per-tick stream + job tracks
# ---------------------------------------------------------------------------


def _events(trc):
    """A tracer's events without their timestamps."""
    return [(e.name, e.ph, e.track, e.cat, e.depth, e.args, e.error)
            for e in trc.events]


def test_cluster_trace_out_and_tracks(tmp_path):
    tracers = {JAX: JTracer(name="cluster"), PORT: TTracer(name="cluster")}
    files = {s: tmp_path / f"cluster_{int(s.port)}.jsonl" for s in SIDES}

    def build(s):
        C = s.C
        train = _trainer(s, "train", iterations=4, k_tasks=4, n=400, f=16,
                         chunk=50, seed=0)
        srv = s.serve(dict(name="svc", kind="serve", priority=1,
                           max_nodes=2),
                      capacity=4, cache_len=32, prefill_bucket=8, seed=0)
        trace = C.ClusterTrace([
            C.arrive(0.0, "train"), C.arrive(1.0, "svc"),
            C.burst(1.0, "svc", 3, prompt_len=[6, 10],
                    max_new_tokens=[3, 5], seed=1),
        ])
        return C.ClusterOrchestrator(s.pool(4), [train, srv], trace,
                                     max_ticks=60, tracer=tracers[s],
                                     trace_out=str(files[s])), [train, srv]

    out = run_both(build)
    assert_same_run(out)
    report = out[PORT][0]
    trc = tracers[PORT]
    lines = [json.loads(x) for x in files[PORT].read_text().splitlines()]
    assert len(lines) == report.ticks
    assert all({"t", "demand", "alloc", "nodes_used"} <= set(l)
               for l in lines)
    assert lines[-1]["nodes_used"] >= 0
    # the JSONL stream, line for line
    assert files[PORT].read_text().splitlines() \
        == files[JAX].read_text().splitlines()
    tracks = set(trc.tracks())
    assert {"allocator", "train", "svc"} <= tracks
    assert tracks == set(tracers[JAX].tracks())
    assert any(e.name == "lease_change" for e in trc.events)
    assert trc.registry.counter("cluster.ticks").value == report.ticks
    assert trc.registry.gauge("cluster.utilization").value \
        == pytest.approx(report.utilization)
    # every counter, gauge and histogram, and every span and instant
    assert trc.registry.snapshot() == tracers[JAX].registry.snapshot()
    assert _events(trc) == _events(tracers[JAX])


# ---------------------------------------------------------------------------
# tests/test_elastic_remesh.py: suspend/resume through cocoa_train_job
# ---------------------------------------------------------------------------


def _solo_and_bumpy(s):
    def make():
        return _trainer(s, iterations=8, k_tasks=4, n=400, f=8, chunk=20,
                        seed=3)

    solo = make()
    solo.arrive(0.0)
    solo.on_allocation([0, 1, 2, 3], [1.0] * 4, 0.0)
    while solo.iterations_done < solo.iterations:
        solo.advance(1.0, float(solo.iterations_done))

    bumpy = make()
    bumpy.arrive(0.0)
    bumpy.on_allocation([0, 1, 2, 3], [1.0] * 4, 0.0)
    bumpy.advance(3.0, 0.0)
    done_before = bumpy.iterations_done
    assert 0 < done_before < bumpy.iterations
    bumpy.on_allocation([], [], 3.0)
    for t in range(3, 6):
        bumpy.advance(1.0, float(t))
    assert bumpy.iterations_done == done_before
    bumpy.on_allocation([5, 6], [1.0, 1.0], 6.0)
    t = 6.0
    while bumpy.iterations_done < bumpy.iterations:
        bumpy.advance(1.0, t)
        t += 1.0
    return solo, bumpy


def test_suspend_resume_bit_identical_params():
    """A trainer squeezed to zero nodes and restored lands bit-identical
    to an uninterrupted run (the port's w and alpha, as the reference's),
    and both runs match the JAX package's."""
    runs = {s: _solo_and_bumpy(s) for s in SIDES}
    solo, bumpy = runs[PORT]
    assert bumpy.iterations_done == solo.iterations_done
    assert solo.loss_curve() == bumpy.loss_curve()
    assert np.array_equal(solo.solver.store.state["alpha"],
                          bumpy.solver.store.state["alpha"])
    assert torch.equal(solo.solver.w, bumpy.solver.w)
    assert bumpy.engine.sim_time > solo.engine.sim_time
    for jj, tj in zip(runs[JAX], runs[PORT]):
        assert_same_job(jj, tj)
        assert tj.engine.sim_time == jj.engine.sim_time


# ---------------------------------------------------------------------------
# an LM job's checkpoint rollback (LMTrainJob.recover)
# ---------------------------------------------------------------------------


def test_lm_train_job_node_failure_rolls_back_to_checkpoint(tmp_path):
    """A node failure rolls the LM job back to its newest snapshot, which
    `load_checkpoint` rebuilds as a new module: `resume` places it (and the
    optimizer state) on the job's device, and the re-run steps see the
    same batches.  The run matches the JAX package's, and the port's final
    parameters equal an uninterrupted trainer's bit for bit."""
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
                           ckpt_dir=str(tmp_path / f"lm_{int(s.port)}"),
                           ckpt_every=3, **s.kw)
        trace = C.ClusterTrace([C.arrive(0.0, "lm"), C.fail(1.5, node=0)])
        return C.ClusterOrchestrator(s.pool(2), [job], trace, dt=1.0,
                                     max_ticks=100), [job]

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out = run_both(build)
        assert_same_run(out)
        rep, jobs, _ = out[PORT]
        job = jobs["lm"]
        assert rep.node_failures == 1 and rep.recoveries == 1
        assert rep.recovery_ticks > 0
        assert job.steps_done == 6 and rep.jobs["lm"]["state"] == "finished"
        assert not job.trainer.suspended
        # an uninterrupted trainer on the same parameters and batches
        ref = ElasticTrainer(PORT.cfg, TTrainConfig(learning_rate=5e-3,
                                                    remat=False),
                             device="cpu")
        init = JM.init_params(JAX.cfg, jax.random.key(0))  # the jobs' seed
        ref.params.load_state_dict(TM.params_from_numpy(
            PORT.cfg, jax.tree.map(np.asarray, init),
            device="cpu").state_dict())
        for i in range(6):
            ref.train_step(batch(i))
        for k, v in ref.params.state_dict().items():
            assert torch.equal(v, job.trainer.params.state_dict()[k]), k
    finally:
        torch.use_deterministic_algorithms(deterministic)


# ---------------------------------------------------------------------------
# tests/test_disagg.py: the allocator sizes both pools as one job
# ---------------------------------------------------------------------------


def test_disagg_serve_job_under_orchestrator():
    """The reference's test, on the port alone: its QueueSplitPolicy reads
    host tick times, so its split decisions are not compared across
    packages."""
    srv = PORT.disagg(dict(name="svc", kind="serve", max_nodes=3),
                      capacity=4, cache_len=32, prefill_bucket=8,
                      split_policy=TQueueSplitPolicy(interval=2), seed=0)
    assert isinstance(srv, TC.ServeJob)  # orchestrator serve gates apply
    trace = TC.ClusterTrace([
        TC.arrive(0.0, "svc"),
        TC.burst(0.0, "svc", 6, prompt_len=[6, 10], max_new_tokens=[3, 6],
                 seed=1),
    ])
    orch = TC.ClusterOrchestrator(PORT.pool(3), [srv], trace, dt=1.0,
                                  max_ticks=300)
    rep = orch.run()
    j = rep.jobs["svc"]
    assert j["state"] == "finished"
    assert j["serve"]["requests_finished"] == 6
    assert j["serve"]["disagg"]["handoffs"] == 6
    assert j["kv_moved_bytes"] > 0
    assert any(kp + kd > 2 for _, kp, kd in
               srv.engine.metrics.split_events)
    assert rep.kv_moved_bytes >= j["kv_moved_bytes"]


def test_disagg_serve_job_with_scheduled_split_and_lease_change():
    """Both packages, one trace: a disagg serve job under a scheduled
    split loses a node to a higher-priority trainer mid-burst (a lease
    shrink that parks decode slots) and gets it back.  Timelines, split
    events, handoffs, streams and summaries are equal."""
    def build(s):
        C = s.C
        pol = (TScheduledSplitPolicy if s.port else JScheduledSplitPolicy)(
            [(2, 2), (6, 1)])
        srv = s.disagg(dict(name="svc", kind="serve", max_nodes=3),
                       capacity=4, cache_len=32, prefill_bucket=8,
                       split_policy=pol, ticks_per_dt=1.0, seed=0)
        hog = _trainer(s, "hog", iterations=4, k_tasks=4, n=400, f=8,
                       chunk=20, seed=0, max_nodes=2)
        hog.spec.priority = 2
        hog.spec.weight = 20.0
        trace = C.ClusterTrace([
            C.arrive(0.0, "svc"),
            C.burst(0.0, "svc", 6, prompt_len=[6, 10],
                    max_new_tokens=[10, 14], seed=1),
            C.arrive(2.0, "hog"),
        ])
        return C.ClusterOrchestrator(s.pool(3), [srv, hog], trace, dt=1.0,
                                     max_ticks=300), [srv, hog]

    out = run_both(build)
    assert_same_run(out)
    rep, jobs, _ = out[PORT]
    srv, jsrv = jobs["svc"], out[JAX][1]["svc"]
    j = rep.jobs["svc"]
    assert j["state"] == "finished"
    assert j["serve"]["requests_finished"] == 6
    assert j["serve"]["disagg"]["handoffs"] == 6
    assert srv.engine.metrics.split_events \
        == jsrv.engine.metrics.split_events
    # the lease changed while the job had work: the trainer squeezed it
    leases = [t.alloc.get("svc", 0) for t in rep.timeline]
    assert len(set(leases)) > 1 and rep.preemptions >= 1
    assert j["kv_moved_bytes"] > 0
    assert srv.engine.prefill.params is srv.engine.decode.params
