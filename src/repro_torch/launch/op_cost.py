"""An aten-level cost counter: the flops, bytes and live memory of every
op a step dispatches, the counterpart of the reference's HLO text walk
(`launch/hlo_cost.py`).

Eager PyTorch runs every layer and every loop trip as its own ops, so the
counts are exact by construction where the reference multiplies while
bodies by their trip counts.  It works the same on meta tensors (the
planner's trace: nothing is allocated) and on the card (the same step's
ops, counted as they run).

  flops  — each op `torch.utils.flop_counter` has a formula for (mm, bmm,
           addmm, baddbmm, convolution, SDPA and their backward ops):
           2 * numel(out) * contracted size, the reference's rule for a
           `dot`.
  bytes  — every tensor input and output of each op (an in-place op's
           self counts read and written, as the reference counts an
           instruction's operands and result).  Eager PyTorch runs each op
           unfused, so this is the counterpart of the reference's
           `bytes_full`.  Views and ops that move nothing (detach, alias,
           empty) count 0, as the reference's `_SKIP_BYTES_OPS`.
  memory — the storages the ops create, alive until their last tensor
           dies (`weakref.finalize` on the storage): the peak of their
           sum, and what the step's outputs still hold.

One card has no collectives, so the reference's collective counts have no
counterpart here.  The reference's other byte estimate models XLA's fusion
on a TPU (layout ops dropped, attention interiors credited to the flash
kernel): nothing in eager PyTorch fuses that way, so it has no
counterpart.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops whose outputs take no traffic: aliases and bare allocations
_NO_BYTES = {aten.detach, aten.alias, aten.lift_fresh, aten._unsafe_view,
             aten._reshape_alias, aten.empty, aten.empty_like,
             aten.empty_strided, aten.new_empty, aten.new_empty_strided}


def tensors(tree: Any) -> Iterable[torch.Tensor]:
    """The tensors of a pytree; a module stands for its parameters."""
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, torch.nn.Module):
            yield from x.parameters()


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree: Any) -> int:
    """Bytes of the distinct storages the tree's tensors live in."""
    seen = {}
    for t in tensors(tree):
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclasses.dataclass
class OpStat:
    count: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class OpCost(TorchDispatchMode):
    """Count what the ops dispatched inside `with OpCost() as c:` do.

    `c.flops`, `c.bytes`, `c.by_op` (aten op name -> OpStat), `c.produced`
    ((op, dtype, shape) -> [bytes, count] of every output an op created),
    `c.peak_bytes` (the most bytes the new storages held at once) and
    `c.live_bytes` (what they hold now).  `hold(tree)` marks the storages
    of tensors made before the mode (the step's arguments): they are
    neither new nor counted in the live bytes."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, OpStat] = collections.defaultdict(OpStat)
        self.produced: Dict[Tuple[str, str, Tuple[int, ...]], list] = \
            collections.defaultdict(lambda: [0, 0])
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}  # id(storage) -> its bytes (0: held)

    def hold(self, tree: Any) -> None:
        for t in tensors(tree):
            self._track(t.untyped_storage(), 0)

    def _track(self, st, n: int) -> None:
        key = id(st)
        if key in self._seen:
            return
        self._seen[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        name = str(packet).replace("aten.", "")
        stat = self.by_op[name]
        stat.count += 1
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            stat.flops += f
            self.flops += f
        if func.is_view:
            return out  # an alias: no traffic, no new storage
        outs = list(tensors(out))
        if packet not in _NO_BYTES:
            b = sum(nbytes(t) for t in tensors((args, kwargs)))
            b += sum(nbytes(t) for t in outs)
            stat.bytes += b
            self.bytes += b
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in self._seen:
                self._track(st, st.nbytes())
                rec = self.produced[(name, str(t.dtype).replace("torch.", ""),
                                     tuple(t.shape))]
                rec[0] += nbytes(t)
                rec[1] += 1
        return out

    def new_bytes(self, tree: Any) -> int:
        """Bytes of the tree's storages that ops inside the mode created
        (a step's outputs, less what aliases its arguments)."""
        seen = {}
        for t in tensors(tree):
            st = t.untyped_storage()
            if self._seen.get(id(st)):
                seen[id(st)] = st.nbytes()
        return sum(seen.values())
