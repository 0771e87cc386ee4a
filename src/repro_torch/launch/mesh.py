"""Meshes: the reference's production meshes, as descriptions, and the
mesh over the devices present.

The JAX package builds its meshes through `compat.py`, which shims JAX's
mesh API (`AxisType`, `make_mesh`, `shard_map`, `set_mesh`) across JAX
versions.  The port has no JAX and builds no device mesh: a `Mesh` here
names axes and sizes, and the planner (`launch/dryrun.py`) reads per-device
shapes from it.  So `compat.py` has no counterpart.

Functions, not module-level constants: importing this module touches no
device state.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's TPU production mesh: 16x16 per pod, 2 pods
    multi-pod.  `configs.INPUT_SHAPES` was sized for these meshes."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: Optional[int] = None) -> Mesh:
    """A data-parallel mesh over the devices present (the CUDA cards, or
    the CPU as one device), or over `data` devices."""
    if data is None:
        data = torch.cuda.device_count() or 1
    return Mesh(("data",), (data,))


def mesh_chips(mesh: Mesh) -> int:
    n = 1
    for v in mesh.shape.values():
        n *= v
    return n
