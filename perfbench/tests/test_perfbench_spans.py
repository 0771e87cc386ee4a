"""The per-layer metrics that read the program's own spans and counts
(`repro_torch.obs.PROGRAM_TRACER`), through each cell's harness path on
the CPU at a small size: a traced run reports them, two traced runs in one
process each read their own spans only, and the CoCoA cell's copy count is
the bytes of the run's passes."""
import pytest

import pb_tiny  # first: it puts perfbench/ and src/ on the path
import pb_harness  # noqa: E402

CELLS = [w["name"] for w in pb_tiny.spec()["workloads"]]


def _program_metrics(workload):
    return {m["name"] for m in pb_harness.for_cell(
        pb_tiny.spec()["per_layer"], workload)
        if m["source"] in ("program_span", "program_counter")}


def _traced(workload, seconds):
    """A traced run of `seconds`, on one CPU thread (on a loaded CPU, many
    threads make these small steps seconds long; on one, a tiny LM step
    takes tens of milliseconds, and the window has to hold three: the
    profiler's warm-up step and the two it records)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return pb_tiny.run(workload, trace=True, seconds=seconds)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def two_traced_runs():
    """Two traced runs of a cell in this process, the second's window twice
    the first's, each with the program tracer's events as its readers saw
    them; made once a cell for the module."""
    from repro_torch.obs import PROGRAM_TRACER
    made = {}

    def runs(workload):
        if workload not in made:
            made[workload] = []
            first = 0.2 if workload.startswith("epsilon") else 1.0
            for seconds in (first, 2 * first):
                res = _traced(workload, seconds)
                made[workload].append((res, list(PROGRAM_TRACER.events)))
        return made[workload]
    return runs


@pytest.mark.parametrize("workload", CELLS)
def test_traced_runs_report_the_program_span_metrics(workload,
                                                     two_traced_runs):
    assert _program_metrics(workload)
    for res, evs in two_traced_runs(workload):
        assert res["correct"]
        assert _program_metrics(workload) <= set(res["metrics"])
        assert all(res["metrics"][m]["value"] > 0
                   for m in _program_metrics(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_two_traced_runs_read_only_their_own_spans(workload,
                                                   two_traced_runs):
    runs = two_traced_runs(workload)
    for res, evs in runs:
        names = [e.name for e in evs]
        if workload.startswith("epsilon"):
            # the whole window is traced: one iteration span a window
            # iteration, and none of the other run's (nor of any traced
            # run before)
            assert names.count("engine.iteration") == \
                res["readings"]["window_iterations"]
        else:
            # `trace_steps` steps after the profiler's warm-up step, and
            # none of the other run's
            steps = pb_tiny.TRAFFIC["train.seq4k"]["trace_steps"]
            assert names.count("train.schedule") == steps
            assert names.count("train.optimizer") == steps


def test_cocoa_copy_mb_is_the_bytes_of_the_runs_passes(two_traced_runs):
    n = pb_tiny.GLM["n_samples"]
    for res, evs in two_traced_runs("epsilon.cocoa.elastic"):
        # per iteration: idx (int32), mask and da (float32) at K x M, sigma
        # (float32) at K, alpha (float32) at n twice: for the pass, the gap
        per_it = [4 * (3 * e.args["K"] * e.args["M"] + e.args["K"] + 2 * n)
                  for e in evs if e.name == "cocoa.scd_pass"]
        assert len(per_it) == res["readings"]["window_iterations"]
        assert res["metrics"]["cocoa_copy_mb.glm"]["value"] == \
            sum(per_it) / len(per_it) / 1e6
