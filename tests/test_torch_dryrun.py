"""The planner (`launch/dryrun.py`, `launch/census.py`) against the JAX
package's dry run.

- `run_one` at published widths on meta for h2o-danube-1.8b x all four
  input shapes and grok-1-314b x decode_32k: the reference's record keys
  (`trace_s` in place of lower/compile seconds, `model_flops` beside the
  counted flops), its parameter count, kind and variant, argument bytes
  equal to the sum over the reference's ShapeDtypeStructs, the roofline
  at H100 constants;
- the census prints its two tables; the CLI writes one record per row
  and exits 0, and 1 when a pair fails;
- the card phase's gates rehearsed on the CPU with smoke configs: the
  step's arguments made real (`real_args`) hold exactly the planner's
  argument bytes, and the step on them counts the meta trace's flops,
  bytes and peak live bytes.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES, get_config
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import model as JM
from repro.sharding import AxisRules as JAxisRules
from repro_torch.configs import ShapeConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.launch import census as TC
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TR
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.op_cost import OpCost, storage_bytes
from repro_torch.sharding import AxisRules
from test_torch_sharding import jleaves, sds, tleaves

REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "variant", "tags",
            "n_params", "memory", "cost", "collectives", "roofline"}


@pytest.mark.parametrize("arch,shape_name", [
    ("h2o-danube-1.8b", s) for s in INPUT_SHAPES] + [
    ("grok-1-314b", "decode_32k")])
def test_run_one_at_published_widths(arch, shape_name):
    rec = TD.run_one(arch, shape_name, verbose=False)
    assert set(rec) == REF_KEYS | {"trace_s"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "peak_bytes"}
    assert set(rec["collectives"]) == {"bytes_by_kind", "count_by_kind",
                                       "total_bytes"}
    assert rec["collectives"]["total_bytes"] == 0
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    ref = JS.input_specs(cfg, shape, JAxisRules(j_host_mesh()))
    assert rec["n_params"] == JM.count_params(cfg)
    assert (rec["kind"], rec["variant"]) == (ref["kind"],
                                             ref.get("variant", "native"))
    want = sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jleaves(ref["args"]).values())
    mem = rec["memory"]
    assert mem["argument_bytes"] == want
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    rf, cost = rec["roofline"], rec["cost"]
    assert cost["flops"] > 0 and cost["bytes_accessed"] > 0
    assert rf["compute_s"] == cost["flops"] / TR.PEAK_FLOPS[cfg.dtype]
    assert rf["memory_s"] == cost["bytes_accessed"] / TR.HBM_BW
    assert rf["bound_s"] == max(rf["compute_s"], rf["memory_s"])
    assert cost["model_flops"] == TR.model_flops_for(t_get_config(arch),
                                                     shape)


def test_census_prints_its_tables(capsys):
    TC.main(["--arch", "grok-1-314b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "== largest tensors produced" in out
    assert "== bytes by op kind" in out
    assert "GiB" in out and " bmm" in out
    assert "== cost model == flops=" in out


def test_cli_writes_a_record_per_row_and_exit_code(tmp_path):
    out = tmp_path / "ok.jsonl"
    with pytest.raises(SystemExit) as e:
        TD.main(["--arch", "h2o-danube-1.8b", "--shape", "long_500k",
                 "--meshes", "--tag", "t", "--out", str(out)])
    assert e.value.code == 0
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["mesh"] for r in recs] == ["1xH100", "16x16", "2x16x16"]
    assert all(r["tags"] == "t" for r in recs)
    assert recs[1]["cost"] is None and recs[1]["memory"]["argument_bytes"]
    bad = tmp_path / "bad.jsonl"
    with pytest.raises(SystemExit) as e:
        TD.main(["--arch", "no-such-arch", "--shape", "long_500k",
                 "--out", str(bad)])
    assert e.value.code == 1
    assert "error" in json.loads(bad.read_text())


CARD_CASES = {
    "train": ("h2o-danube-1.8b", ShapeConfig("train_4k", 64, 2, "train")),
    "prefill": ("whisper-small", ShapeConfig("prefill", 64, 2, "prefill")),
    "decode": ("grok-1-314b", ShapeConfig("decode_32k", 96, 2, "decode")),
    "ring": ("qwen3-4b", ShapeConfig("long_500k", 524288, 1, "decode")),
    "ssm": ("rwkv6-1.6b", ShapeConfig("decode_32k", 128, 3, "decode")),
}


@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_gates_rehearsed_on_cpu(case):
    arch, shape = CARD_CASES[case]
    cfg = dataclasses.replace(t_smoke_variant(t_get_config(arch)),
                              dtype="float32")
    spec = TS.input_specs(cfg, shape, AxisRules(make_host_mesh(data=1)))
    cost, out, _ = TD.trace(cfg, spec)
    mem = TD.memory_record(cost, spec["args"], out)
    del out
    args = TD.real_args(cfg, spec, torch.Generator().manual_seed(0), "cpu")
    got = {f"{i}/{k}": v for i, a in enumerate(args)
           for k, v in tleaves(a).items()}
    want = {f"{i}/{k}": v for i, a in enumerate(spec["args"])
            for k, v in tleaves(a).items()}
    assert sds(got) == sds(want)
    assert all(t.device.type == "cpu" for t in got.values())
    assert storage_bytes(args) == mem["argument_bytes"]
    real = OpCost()
    real.hold(args)
    with real:
        out = TS.build_step(cfg, spec)(*args)
    assert real.flops == cost.flops
    assert real.bytes == cost.bytes
    assert real.peak_bytes == cost.peak_bytes
    assert real.new_bytes(out) == mem["output_bytes"]
