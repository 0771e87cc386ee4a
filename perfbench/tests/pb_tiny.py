"""Small sizes of the benchmark's cells for its CPU tests: every width and
count cut so that a whole run (set-up, a short window, the check against
the plain reference) takes a second or two on a CPU."""
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
for p in (str(ROOT / "src"), str(PB)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pb_harness  # noqa: E402

# float32 here: at these widths bfloat16's rounding reads above limits set
# for the published widths; the control and the faults still fail them
LM = dict(hidden_size=64, intermediate_size=128, num_attention_heads=16,
          num_key_value_heads=4, head_dim=8, num_hidden_layers=2,
          vocab_size=256, sliding_window=48, torch_dtype="float32")
GLM = dict(n_samples=2000, n_features=64, chunk_size=125)
CONFIG = {"h2o-danube-1.8b": LM, "svm-epsilon": GLM}
TRAFFIC = {"train.seq4k": dict(seq_len=64, batch=6, n_seqs=256,
                               trace_skip=0, trace_steps=2),
           "cocoa.elastic": dict(workers=[[4, 3], [2, 2]])}
SEED = 2 ** 31 + 12345  # past 32 signed bits: seeds that large must work


def spec():
    return pb_harness.load_json(ROOT / "BENCHMARK.json")


def spec_config(name):
    """A configuration's file as `BENCHMARK.json` names it."""
    c = {c["name"]: c for c in spec()["configs"]}[name]
    return pb_harness.load_json(ROOT / c["file"])


def run(workload, *, trace=False, fault=None, program="port",
        seconds=0.2, seed=SEED):
    s = spec()
    cell = {w["name"]: w for w in s["workloads"]}[workload]
    r = pb_harness.Run(s, workload, root=ROOT,
                       overrides=CONFIG[cell["config"]],
                       traffic_overrides=TRAFFIC[cell["traffic"]],
                       fault=fault, program=program)
    return r(seed, seconds, trace, "cpu", time.perf_counter())
