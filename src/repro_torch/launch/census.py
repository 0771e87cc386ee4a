"""Buffer and traffic census of one step, from the planner's meta trace:
the largest tensors the step's ops produce and the bytes and flops by op
kind — the counterpart of the reference's HLO census.

    PYTHONPATH=src python -m repro_torch.launch.census --arch grok-1-314b \
        --shape decode_32k [--accum A]

Eager PyTorch runs every layer and loop trip as its own ops, so a tensor
is counted at every execution; the reference counts each HLO instruction
once (a scanned layer's buffers once, not once a layer).
"""
from __future__ import annotations

import argparse

from ..configs import INPUT_SHAPES, TrainConfig, get_config
from ..sharding import AxisRules
from . import steps
from .dryrun import trace
from .mesh import make_host_mesh
from .op_cost import OpCost


def census(cost: OpCost, min_bytes: float = 50e6, top: int = 25) -> None:
    big = sorted(((b, n, k) for k, (b, n) in cost.produced.items()
                  if b / n > min_bytes), reverse=True)
    print("== largest tensors produced (sum over executions) ==")
    for b, n, (op, dt, shape) in big[:top]:
        dims = ",".join(str(d) for d in shape)
        print(f"{b / 2 ** 30:8.2f}GiB {n:6d}x  {op} {dt}[{dims}]")
    print("== bytes by op kind (every execution) ==")
    kinds = sorted(cost.by_op.items(), key=lambda kv: -kv[1].bytes)
    for name, st in kinds[:15]:
        print(f"{st.bytes / 2 ** 30:10.2f}GiB {st.count:8d}x "
              f"{st.flops:10.3e} flops  {name}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--accum", type=int, default=1)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    shape = INPUT_SHAPES[args.shape]
    tc = TrainConfig(accum_steps=args.accum)
    spec = steps.input_specs(cfg, shape, AxisRules(make_host_mesh(data=1)),
                             tc)
    cost, _, _ = trace(cfg, spec)
    census(cost)
    print(f"== cost model == flops={cost.flops:.3e} bytes={cost.bytes:.3e} "
          f"peak_live={cost.peak_bytes:.3e}")


if __name__ == "__main__":
    main()
