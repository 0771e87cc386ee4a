"""Each cell's harness path end to end on the CPU at a small size: set-up,
a short window, the check against the plain reference, and the result's
last line in the contract's shape."""
import json

import pytest

import pb_tiny  # first: it puts perfbench/ and src/ on the path
import pb_harness  # noqa: E402

CELLS = [w["name"] for w in pb_tiny.spec()["workloads"]]


def _e2e(workload):
    return {m["name"] for m in pb_harness.for_cell(
        pb_tiny.spec()["end_to_end"], workload)}


def _layer(workload):
    return {m["name"] for m in pb_harness.for_cell(
        pb_tiny.spec()["per_layer"], workload)}


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_with_its_end_to_end_metrics(workload):
    res = pb_tiny.run(workload)
    assert res["correct"], res["compared"]
    assert set(res["metrics"]) == _e2e(workload)
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["attempted"] >= 1 and res["failed"] == 0
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 1}
    line = json.loads(pb_harness.result_line(res, device))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert all(set(v) == {"value", "limit"}
               for v in line["compared"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_only_per_layer_metrics(workload):
    res = pb_tiny.run(workload, trace=True)
    assert res["correct"]
    # on the CPU the readers of device time find nothing and stay silent
    assert res["metrics"] and set(res["metrics"]) <= _layer(workload)
    assert "trace" not in res


def test_forbidden_modules_by_whole_top_level_name():
    assert pb_harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "torch", "jaxtyping"]) == []
    assert pb_harness.forbidden_modules(
        ["repro_torch", "repro.core", "jax", "flax.linen"]) == [
            "flax.linen", "jax", "repro.core"]


def test_lm_reference_in_row_blocks_is_the_whole_batch():
    import torch

    import pb_inputs
    from reference import lm_ref
    c = dict(pb_tiny.spec_config("h2o-danube-1.8b"))
    c.update(pb_tiny.LM)
    w = pb_inputs.lm_weights(torch, c, pb_tiny.SEED, "cpu")
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, c["vocab_size"], (5, 33), generator=g)
    wts = torch.rand(5, generator=g) + 0.5
    out = []
    for rows in (1, 2, 5):
        r = lm_ref.LMReference(torch, c, w, row_block=rows)
        out.append(r.step(tok[:, :-1], tok[:, 1:], wts))
    for loss, grads in out[:-1]:
        assert abs(loss - out[-1][0]) <= 1e-5 * abs(out[-1][0])
        assert all(abs(v - out[-1][1][k]) <= 1e-4 * out[-1][1][k]
                   for k, v in grads.items())
