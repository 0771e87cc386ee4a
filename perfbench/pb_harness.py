"""The benchmark's harness: one cell, one run, one process.

Everything particular to a configuration, a traffic mix or a metric sits
in files of its own, found by the names in `BENCHMARK.json`:

- `configs/<config>.json`: the configuration as it is run; its `system`
  names its system module, `systems/<system>.py`, which builds the program
  and holds the check of what the program produced;
- `traffic/<traffic>.json`: the mix's parameters, read by the system module;
- `limits/<workload>.json`: each compared number's limit, with the
  readings it was set from;
- `metrics/<metric>.py`: a reader `read(ctx)` of one per-layer metric,
  returning None where it finds nothing to read.

A run: set-up (inputs from the seed, the program built, every shape of
the cell warmed, counted in `setup_s` from the process's start), then the
window of `--seconds` (whole steps: it ends when the step that crosses
the time ends), then the device's peak memory is read, the program freed
and its outputs checked against the plain reference.  With `--trace 1`
the window runs under `torch.profiler` and the run reports the cell's
per-layer metrics and a breakdown; with `--trace 0` its end-to-end
metrics.  The last line of standard output is the result.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules: Optional[Iterable[str]] = None) -> List[str]:
    """Modules loaded (in `modules`, default this process's) whose
    top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules if modules is None
                                   else modules)
                   if m.split(".")[0] in FORBIDDEN})


def for_cell(entries: List[Dict], workload: str) -> List[Dict]:
    """The metrics of a list that a cell reports: those without a
    `workloads` key, and those that name it."""
    return [e for e in entries
            if "workloads" not in e or workload in e["workloads"]]


class Run:
    """One cell's run.  `overrides` replace configuration keys and
    `traffic_overrides` traffic keys (the CPU tests' small sizes);
    `fault` plants a fault in the timed path; `program` other than "port"
    puts the plain reference at a lower precision in the program's place
    (the control)."""

    def __init__(self, spec: Dict, workload: str, *, root: Path,
                 overrides: Optional[Dict] = None,
                 traffic_overrides: Optional[Dict] = None,
                 fault: Optional[str] = None, program: str = "port"):
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"have {sorted(cells)}")
        self.spec, self.cell = spec, cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        self.cfg = load_json(root / configs[self.cell["config"]]["file"])
        self.cfg.update(overrides or {})
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.cell['traffic']}.json")
        self.traffic.update(traffic_overrides or {})
        self.limits = load_json(HERE / "limits" / f"{workload}.json")
        self.system = load_module(HERE / "systems"
                                  / f"{self.cfg['system']}.py",
                                  f"pb_system_{self.cfg['system']}")
        self.fault, self.program = fault, program

    def __call__(self, seed: int, seconds: float, trace: bool, device: str,
                 t0: float) -> Dict:
        import torch
        cuda = torch.device(device).type == "cuda"
        cell = self.system.Cell(self.cfg, self.traffic, seed, device,
                                fault=self.fault, program=self.program)
        try:
            res = self._measure(torch, cell, seconds, trace, cuda, t0)
        finally:
            cell.release()  # the program's state (and any patch) goes
        res["compared"] = cell.check(self.limits["limits"])
        res["readings"] = getattr(cell, "readings", {})
        res["correct"] = all(c["value"] <= c["limit"]
                             for c in res["compared"])
        return res

    def _measure(self, torch, cell, seconds: float, trace: bool,
                 cuda: bool, t0: float) -> Dict:
        """Set-up, the window and the metrics; then the peak memory."""
        cell.setup()
        if cuda:
            torch.cuda.synchronize()
        prof = self._profiler(torch, cuda) if trace else None
        if prof is not None:
            prof.start()
        w0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("pb.step"):
                cell.step()
            now = time.perf_counter()
            if prof is not None:
                prof.step()
            if now - w0 >= seconds:
                break
        window_s = now - w0
        setup_s = w0 - t0
        if prof is not None:
            prof.stop()
        res: Dict = {"attempted": cell.attempted(), "failed": 0,
                     "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                           if cuda else 0)}
        if trace:
            import pb_yardstick
            summary = pb_yardstick.device_summary(prof.events(), "pb.step")
            ctx = dict(cell.layer_context(), config=self.cfg,
                       traffic=self.traffic, window_s=window_s,
                       trace=summary, yardstick=pb_yardstick)
            res["metrics"] = self._per_layer(ctx)
            if summary is not None:
                res["breakdown"] = {k: summary[k]
                                    for k in ("device_ops", "idle_gaps")}
                res["trace"] = {k: summary[k] for k in ("busy_s", "window_s")}
        else:
            values = dict(cell.end_to_end(window_s), setup_s=setup_s)
            res["metrics"] = self._end_to_end(values)
        return res

    def _profiler(self, torch, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        n = self.traffic.get("trace_steps", 0)
        if not n:
            return profile(activities=acts)
        # trace `n` steps after `trace_skip` untraced ones (and one step
        # of the profiler's own warm-up)
        return profile(activities=acts, schedule=schedule(
            wait=self.traffic.get("trace_skip", 0), warmup=1, active=n,
            repeat=1))

    def _end_to_end(self, values: Dict[str, float]) -> Dict:
        out = {}
        for m in for_cell(self.spec["end_to_end"], self.cell["name"]):
            if m["name"] not in values:
                raise KeyError(f"the {self.cfg['system']} system does not "
                               f"report {m['name']}")
            out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        return out

    def _per_layer(self, ctx: Dict) -> Dict:
        out = {}
        for m in for_cell(self.spec["per_layer"], self.cell["name"]):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 f"pb_metric_{m['name'].replace('.', '_')}")
            v = reader.read(ctx)
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out


def result_line(res: Dict, device: Dict) -> str:
    """The contract's last line: `compared` last, each number with its
    limit."""
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in res["compared"]}
    return json.dumps(line)


def main(args, t0: float, root: Path) -> int:
    import torch
    spec = load_json(root / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in spec["workloads"]}
    if args.workload not in chips:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips[args.workload]:
        print(f"perfbench: {args.workload} needs {chips[args.workload]} "
              f"CUDA device(s); this machine has {have}", file=sys.stderr)
        return 3
    run = Run(spec, args.workload, root=root)
    res = run(args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:  # the window has closed: what the port loaded is here
        print(f"perfbench: the run loaded {found}; the benchmark measures "
              "the port alone", file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
              "count": chips[args.workload],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        tr = res.get("trace")
        if tr is None:
            print("perfbench: the profiler recorded no device time in the "
                  "traced window", file=sys.stderr)
            return 4
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    for k, v in res["readings"].items():
        print(f"reading {k}: {v}", file=sys.stderr)
    for c in res["compared"]:
        print(f"compared {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}",
              file=sys.stderr)
    print(result_line(res, device), flush=True)
    return 0
