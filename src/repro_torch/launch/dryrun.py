"""The planner: trace every (arch x input-shape) step on the meta device,
at published widths, and report what it holds in memory, what work it
does and what bounds it on one H100 — the counterpart of the reference's
multi-pod dry run, which lowers each step onto 512 placeholder XLA devices.
Nothing is allocated and no GPU is needed.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch X]
        [--shape Y] [--accum A] [--infer-2d] [--meshes] [--tag T]
        [--out FILE]

One JSON record per pair (appended to --out), with the reference's keys:
  mesh "1xH100": the whole step on one card.  memory: the arguments'
    bytes (parameters, optimizer state, batch, cache), the outputs' new
    bytes, the peak of the bytes the step's ops hold at once on top of
    the arguments (`peak_bytes` counts both) and its excess over the
    outputs (`temp_bytes`); cost: the op counter's flops and bytes
    (`launch/op_cost.py`) and the analytic model flops; roofline: at H100
    constants (`launch/roofline.py`).  `trace_s` takes the place of the
    reference's lower/compile seconds.
  --meshes adds rows for the reference's "16x16" and "2x16x16" meshes:
    the per-device argument bytes under its partition specs and the
    parameter count.  Torch has no SPMD partitioner for this code, so
    per-device flops and collectives are not derived: cost, collectives
    and roofline are null there.
The CLI ends with one line: the pairs, the failed rows, the seconds, and
each mesh's argument bytes summed over the pairs; it exits non-zero if any
pair fails.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, Iterator, Tuple

import torch

from ..configs import INPUT_SHAPES, TrainConfig, get_config, list_archs
from ..models import model as M
from ..optim import optimizers as opt
from ..sharding import AxisRules, Mesh, Spec, shard_shape
from . import roofline as R
from . import steps
from .mesh import make_host_mesh, make_production_mesh, mesh_chips
from .op_cost import OpCost, storage_bytes

ONE_CARD = "1xH100"
NO_PARTITIONER = ("no SPMD partitioner for this code in torch: per-device "
                  "flops and collectives are not derived")


def archs() -> Tuple[str, ...]:
    return tuple(a for a in list_archs() if not a.startswith("chicle"))


def arg_spec_pairs(args: Any, specs: Any) -> Iterator[Tuple[torch.Tensor,
                                                             Spec]]:
    """(tensor, spec) for every tensor of `input_specs`' args beside its
    in_specs entry (a parameter module pairs with the param_defs-keyed
    spec tree)."""
    if isinstance(args, torch.Tensor):
        yield args, specs
    elif isinstance(args, torch.nn.Module):
        flat = steps.by_path(specs)
        for path, p in M.param_dict(args).items():
            yield p, flat[path]
    elif isinstance(args, dict):
        for k, v in args.items():
            yield from arg_spec_pairs(v, specs[k])
    elif isinstance(args, tuple):  # the step's arguments, an OptState
        for a, s in zip(args, specs):
            if a is not None:
                yield from arg_spec_pairs(a, s)
    else:
        raise TypeError(f"no spec pairing for {type(args)}")


def per_device_bytes(spec: Dict[str, Any], mesh: Mesh) -> int:
    """The bytes one device of `mesh` holds of the step's arguments."""
    total = 0
    for t, s in arg_spec_pairs(spec["args"], spec["in_specs"]):
        n = 1
        for d in shard_shape(tuple(t.shape), s, mesh):
            n *= d
        total += n * t.element_size()
    return total


def trace(cfg, spec: Dict[str, Any]) -> Tuple[OpCost, Any, float]:
    """Run `build_step`'s step once on `spec["args"]` under the op
    counter -> (counter, outputs, seconds)."""
    step = steps.build_step(cfg, spec)
    cost = OpCost()
    cost.hold(spec["args"])
    t0 = time.perf_counter()
    with cost:
        out = step(*spec["args"])
    return cost, out, time.perf_counter() - t0


def memory_record(cost: OpCost, args: Any, out: Any) -> Dict[str, int]:
    arg = storage_bytes(args)
    out_b = cost.new_bytes(out)
    return {"argument_bytes": arg, "output_bytes": out_b,
            "temp_bytes": max(cost.peak_bytes - out_b, 0),
            "peak_bytes": arg + cost.peak_bytes}


def run_one(arch: str, shape_name: str, *, shape=None, tc=None,
            inference_2d: bool = False, extra_tags: str = "",
            verbose: bool = True) -> Dict[str, Any]:
    """The whole step on one card, traced on meta tensors.  shape: in
    place of INPUT_SHAPES[shape_name] (a cut batch; say so in
    extra_tags)."""
    cfg = get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    rules = AxisRules(make_host_mesh(data=1),
                      inference_2d=inference_2d and shape.kind == "decode")
    spec = steps.input_specs(cfg, shape, rules, tc)
    cost, out, trace_s = trace(cfg, spec)
    mem = memory_record(cost, spec["args"], out)
    del out
    model_flops = R.model_flops_for(cfg, shape)
    rf = R.roofline_terms(flops=cost.flops, bytes_accessed=cost.bytes,
                          model_flops=model_flops, dtype=cfg.dtype)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": ONE_CARD, "chips": 1,
        "kind": spec["kind"], "variant": spec.get("variant", "native"),
        "tags": extra_tags, "trace_s": trace_s,
        "n_params": M.count_params(cfg),
        "memory": mem,
        "cost": {"flops": cost.flops, "bytes_accessed": cost.bytes,
                 "model_flops": model_flops},
        # one card: no collectives (the reference's keys, empty)
        "collectives": {"bytes_by_kind": {}, "count_by_kind": {},
                        "total_bytes": 0},
        "roofline": rf.row(),
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {ONE_CARD} "
              f"({spec['kind']}, {rec['variant']}) OK trace={trace_s:.1f}s",
              flush=True)
        print(f"  memory: args={_gb(mem['argument_bytes'])} "
              f"temp={_gb(mem['temp_bytes'])} peak={_gb(mem['peak_bytes'])}")
        print(f"  cost: flops={cost.flops:.3e} bytes={cost.bytes:.3e}")
        print(f"  roofline: compute={rf.compute_s * 1e3:.2f}ms "
              f"memory={rf.memory_s * 1e3:.2f}ms -> {rf.bottleneck}-bound; "
              f"useful={rf.useful_ratio:.2f}", flush=True)
    return rec


def mesh_record(arch: str, shape_name: str, *, multi_pod: bool, tc=None,
                inference_2d: bool = False, extra_tags: str = "",
                verbose: bool = True) -> Dict[str, Any]:
    """Per-device argument bytes under the reference's production mesh."""
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = AxisRules(mesh,
                      inference_2d=inference_2d and shape.kind == "decode")
    spec = steps.input_specs(cfg, shape, rules, tc)
    arg = per_device_bytes(spec, mesh)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh.name,
        "chips": mesh_chips(mesh), "kind": spec["kind"],
        "variant": spec.get("variant", "native"), "tags": extra_tags,
        "n_params": M.count_params(cfg),
        "memory": {"argument_bytes": arg, "output_bytes": None,
                   "temp_bytes": None, "peak_bytes": None},
        "cost": None, "collectives": None, "roofline": None,
        "note": NO_PARTITIONER,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh.name}: "
              f"args/device={_gb(arg)}", flush=True)
    return rec


def real_args(cfg, spec: Dict[str, Any], generator: torch.Generator,
              device) -> tuple:
    """`spec["args"]` made real on `device`: random parameters from
    `generator`, a zero optimizer state, random tokens, unit weights,
    random memory embeddings, an empty cache (k_pos -1) and pos at the
    cache's last row, every tensor of the meta one's shape and dtype."""
    params = M.init_params(cfg, generator, device)
    meta = spec["args"]

    def tokens(t):
        return torch.randint(0, cfg.vocab_size, tuple(t.shape),
                             generator=generator, device=device,
                             dtype=t.dtype)

    def batch_of(b):
        out = {"tokens": tokens(b["tokens"])}
        if "labels" in b:
            out["labels"] = tokens(b["labels"])
            out["weights"] = torch.ones(tuple(b["weights"].shape),
                                        device=device)
        if "memory" in b:
            m = b["memory"]
            out["memory"] = torch.randn(tuple(m.shape), generator=generator,
                                        device=device).to(m.dtype)
        return out

    if spec["kind"] == "train":
        state = opt.init_opt_state(M.param_dict(params),
                                   optimizer=spec["train_cfg"].optimizer)
        return params, state, batch_of(meta[2])
    if spec["kind"] == "prefill":
        return params, batch_of(meta[1])
    # the ssm state has no rows (and no k_pos)
    cache_len = meta[1]["k_pos"].shape[0] if "k_pos" in meta[1] else 1
    cache = M.init_cache(cfg, meta[2].shape[0], cache_len, device,
                         cross_len=steps.memory_len(cfg))
    pos = torch.tensor(cache_len - 1, dtype=torch.int32, device=device)
    return params, cache, tokens(meta[2]), pos


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 2 ** 30:.2f}GiB"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train shapes)")
    ap.add_argument("--infer-2d", action="store_true",
                    help="decode: replicate activations over data; weights "
                         "stay 2D-sharded (changes the meshes' rows)")
    ap.add_argument("--meshes", action="store_true",
                    help="add per-device argument rows for 16x16 and "
                         "2x16x16")
    ap.add_argument("--tag", default="", help="tag recorded with each row")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)
    tc = TrainConfig(accum_steps=args.accum)

    names = [args.arch] if args.arch else list(archs())
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    kw = dict(tc=tc, inference_2d=args.infer_2d, extra_tags=args.tag)
    n_fail = 0
    t0 = time.perf_counter()
    arg_sums: Dict[str, int] = {}
    for arch in names:
        for shape in shapes:
            rows = [(ONE_CARD, lambda: run_one(arch, shape, **kw))]
            if args.meshes:
                rows += [(m, lambda mp=mp: mesh_record(
                    arch, shape, multi_pod=mp, **kw))
                    for m, mp in (("16x16", False), ("2x16x16", True))]
            for mesh, make in rows:
                try:
                    rec = make()
                except Exception as e:  # noqa: BLE001 — report, go on
                    n_fail += 1
                    print(f"[dryrun] {arch} x {shape} x {mesh} FAILED: "
                          f"{e!r}", flush=True)
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "error": repr(e)[:500]}
                else:
                    arg_sums[mesh] = arg_sums.get(mesh, 0) \
                        + rec["memory"]["argument_bytes"]
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] {len(names) * len(shapes)} pairs, {n_fail} rows "
          f"failed, {time.perf_counter() - t0:.1f}s; argument bytes summed "
          f"over the pairs by mesh: {arg_sums}", flush=True)
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
