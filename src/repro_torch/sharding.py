"""Logical-axis sharding rules over a mesh description: map the models'
logical axis names onto mesh axes, the JAX package's `sharding.py`.

A `Mesh` here is a description (axis names and sizes), not a set of
devices: the port runs a step on one card and answers, for the reference's
meshes, what each device would hold.  Meshes (`launch/mesh.py`):
  single-pod:  ("data", "model")            = (16, 16)
  multi-pod:   ("pod", "data", "model")     = (2, 16, 16)
  host:        ("data",)                    = (n_devices,)

Logical axes used by the models:
  batch   -> ("pod", "data")   (also the Chicle uni-task worker axis)
  fsdp    -> ("pod", "data")   weight sharding on the d_model-ish dim (ZeRO-3)
  tensor  -> "model"           heads / d_ff / vocab / expert-ffn
  seq     -> None              (the reference maps it to "model" only under
                               sequence parallelism, which reaches the model
                               through its in-model layout hints, below)

A spec is a plain tuple whose entries are None, a mesh-axis name or a tuple
of names (a tuple of one name is written as the name, as `PartitionSpec`
canonicalizes it): the counterpart of a `PartitionSpec`, so
`tuple(P(...))` compares to it directly.  `guard` drops every mapping whose dim does not divide
evenly, so `shard_shape` is exact division.

The reference's `use_weight`, `constrain`, `constrain_fwd_only` and
`pin_grad` are GSPMD layout hints inside the model, and `sharding()` builds
a `NamedSharding` over real devices.  On one device the hints are
identities and there is no `NamedSharding`; the port's models call none of
them, so they have no counterpart here, and neither have the options and
axes only they read: `seq_parallel`, `fsdp=False` and the "expert" axis.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

Axis = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Axis, ...]


def canonical(ax: Axis) -> Axis:
    """An entry of a spec as `PartitionSpec` writes it: ("data",) ->
    "data"."""
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh by axis names and sizes (no devices)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """axis name -> size, as `jax.sharding.Mesh.shape`."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def name(self) -> str:
        """"16x16", "2x16x16", "1", ..."""
        return "x".join(str(n) for n in self.axis_sizes)


class AxisRules:
    """Resolve logical axis names to mesh axes present in the mesh.  The
    mesh is anything with `axis_names` and a name -> size `shape`."""

    def __init__(self, mesh: Mesh, *, inference_2d: bool = False):
        """inference_2d: decode-time regime — ACTIVATIONS replicate over the
        data axes while weights keep their 2D (data x model) sharding; KV
        caches keep batch sharding via the 'cache_batch' logical axis."""
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.inference_2d = inference_2d

    def _have(self, *names: str) -> Tuple[str, ...]:
        return tuple(n for n in names if n in self.axis_names)

    # --- logical axes -------------------------------------------------
    @property
    def batch(self) -> Axis:
        if self.inference_2d:
            return None
        return self._have("pod", "data") or None

    @property
    def cache_batch(self) -> Axis:
        return self._have("pod", "data") or None

    @property
    def fsdp(self) -> Axis:
        return self._have("pod", "data") or None

    @property
    def tensor(self) -> Axis:
        return "model" if "model" in self.axis_names else None

    @property
    def seq(self) -> Axis:
        return None

    def axis_size(self, logical: Axis) -> int:
        if logical is None:
            return 1
        names = (logical,) if isinstance(logical, str) else logical
        n = 1
        for name in names:
            n *= self.mesh.shape[name]
        return n

    # --- spec builders -------------------------------------------------
    def spec(self, *axes: Optional[str]) -> Spec:
        """A spec from logical axis names (or None)."""
        resolved = []
        for a in axes:
            if a is None:
                resolved.append(None)
            elif a in ("batch", "cache_batch", "fsdp", "tensor", "seq"):
                resolved.append(getattr(self, a))
            else:
                raise ValueError(f"unknown logical axis {a!r}")
        return tuple(canonical(a) for a in resolved)

    def fsdp_spec(self, *axes: Optional[str], dim_sizes=None) -> Spec:
        """Like spec() but drops any mapping whose dim is not divisible by
        the resolved mesh-axis size (e.g. whisper's vocab 51865 cannot
        shard 16 ways)."""
        spec = self.spec(*axes)
        if dim_sizes is None:
            return spec
        return self.guard(spec, tuple(dim_sizes))

    def guard(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """Drop spec entries whose dim size is not divisible by the shards
        (and every entry over one shard); one entry per dim of shape."""
        fixed = []
        for ax, sz in zip(tuple(spec) + (None,) * (len(shape) - len(spec)),
                          shape):
            n = self.axis_size(ax)
            fixed.append(canonical(ax) if n > 1 and sz % n == 0 else None)
        return tuple(fixed)


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The per-device shape of a `shape` array laid out by a guarded
    `spec` on `mesh`: each sharded dim divided by its axes' size."""
    sizes = mesh.shape
    out = []
    for i, sz in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        names = () if ax is None else (ax,) if isinstance(ax, str) else ax
        n = 1
        for name in names:
            n *= sizes[name]
        if sz % n:
            raise ValueError(f"dim {i} of {shape} does not divide into "
                             f"{n} shards ({spec}); guard the spec first")
        out.append(sz // n)
    return tuple(out)
