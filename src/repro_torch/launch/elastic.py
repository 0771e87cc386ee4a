"""True device elasticity: REMESH mode.

The Chicle engine's host-side mode changes worker weights without touching
the train step (used by launch/train.py).  This module is the other half:
when the device pool itself changes, the training state is re-placed on
the active devices — the paper's "spawn/terminate tasks + redistribute
chunks" at the device level — and a full revocation parks it in host
memory until devices come back.

The JAX package rebuilds a mesh over the first k devices and replicates
the state over it.  The port's train step runs on one device, so the state
lives on the first CUDA device (or the CPU when the caller asks for it)
and k counts the devices granted, clamped to the cards present; on one
card k is 1.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, TrainConfig
from ..models import model as M
from ..optim import OptState, init_opt_state, tree_map
from . import steps


class ElasticTrainer:
    """Elastic trainer with state carry-over.

    - `resize(k)`: place params + optimizer state on the first device of
      the k granted (the chunk-transfer analogue for model state); the
      train step is built once and serves every k.
    - `suspend()` moves the state to host tensors, releasing the device;
      `resume(k)` brings it back.  The round trip is bit-exact.
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, seed: int = 0,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ElasticTrainer runs on CUDA by default and no CUDA "
                    "device is available; pass device='cpu' to run on the "
                    "CPU")
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        else:
            self.devices = [device]
        self.cfg = cfg
        self.tc = tc
        gen = torch.Generator(device=self.devices[0]).manual_seed(seed)
        self.params = M.init_params(cfg, gen, self.devices[0])
        self.opt_state = init_opt_state(M.param_dict(self.params),
                                        optimizer=tc.optimizer)
        self.step = steps.make_train_step(cfg, tc)
        self.k = 0
        self.suspended = False
        self.resize(len(self.devices))

    def _place(self, device) -> None:
        self.params = self.params.to(device)
        self.opt_state = OptState(*(
            None if v is None else tree_map(lambda t: t.to(device), v)
            for v in self.opt_state))

    def resize(self, k: int) -> None:
        k = max(1, min(k, len(self.devices)))
        if k == self.k and not self.suspended:
            return
        self.suspended = False
        self._place(self.devices[0])
        self.k = k

    def suspend(self) -> None:
        """Full revocation (cluster scale-to-zero): pull the training state
        to host memory, releasing every device; `resume(k)` places it on
        whatever devices come back.  Training continues as if never
        interrupted."""
        if self.suspended:
            return
        self._place(torch.device("cpu"))
        self.suspended = True
        self.k = 0

    def resume(self, k: int) -> None:
        self.resize(k)

    def train_step(self, batch: Dict) -> Dict:
        if self.suspended:
            raise RuntimeError("ElasticTrainer is suspended; call resume(k) "
                               "before stepping")
        self.params, self.opt_state, metrics = self.step(
            self.params, self.opt_state,
            steps.to_device(batch, self.devices[0]))
        return {k: float(v) for k, v in metrics.items()}
