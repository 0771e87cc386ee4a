"""Small nets for the paper's own workloads (§5.1), as plain functions on a
dict of tensors (PyTorch).

The paper's DNN: "a CNN with relu activations composed of two convolutional
layers with max-pooling followed by 3 fully connected layers" trained on
CIFAR-10 / Fashion-MNIST; plus an MLP used by fast unit tests.

Layouts.  Images come in NHWC, as in the JAX package (`data.make_images`),
and are permuted to NCHW for the convolutions.  Conv weights are OIHW and
the flattened conv features are in CHW order, PyTorch's own; so
`params_from_numpy` turns the JAX package's HWIO conv weights into OIHW
and reorders the rows of `f1` from the JAX package's HWC flatten to CHW.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.chicle_paper import CNNConfig

Params = Dict[str, torch.Tensor]


def _randn(gen: torch.Generator, *shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device) * std


def cnn_init(cfg: CNNConfig, generator: torch.Generator) -> Params:
    """He-normal weights from `generator` (on the generator's device)."""
    c1, c2 = cfg.conv_channels
    f1, f2 = cfg.fc_sizes
    side = cfg.image_size // 4  # two 2x2 maxpools
    flat = side * side * c2
    dev = generator.device

    def dense(i, o):
        return _randn(generator, i, o, std=math.sqrt(2.0 / i))

    def zeros(n):
        return torch.zeros(n, device=dev)

    return {
        "c1": _randn(generator, c1, cfg.channels, 3, 3,
                     std=math.sqrt(2.0 / (9 * cfg.channels))),
        "b1": zeros(c1),
        "c2": _randn(generator, c2, c1, 3, 3, std=math.sqrt(2.0 / (9 * c1))),
        "b2": zeros(c2),
        "f1": dense(flat, f1), "fb1": zeros(f1),
        "f2": dense(f1, f2), "fb2": zeros(f2),
        "f3": dense(f2, cfg.num_classes), "fb3": zeros(cfg.num_classes),
    }


def cnn_apply(params: Mapping[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, classes).  3x3 "SAME" convolutions
    (padding 1, stride 1), 2x2 VALID max pools."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, params["c1"], params["b1"],
                                     padding=1)), 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, params["c2"], params["b2"],
                                     padding=1)), 2)
    h = h.reshape(h.shape[0], -1)  # CHW order
    h = F.relu(h @ params["f1"] + params["fb1"])
    h = F.relu(h @ params["f2"] + params["fb2"])
    return h @ params["f3"] + params["fb3"]


def mlp_init(generator: torch.Generator, n_features: int, n_classes: int,
             hidden: Tuple[int, ...] = (64,)) -> Params:
    dims = (n_features,) + hidden + (n_classes,)
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = _randn(generator, a, b, std=math.sqrt(2.0 / a))
        params[f"b{i}"] = torch.zeros(b, device=generator.device)
    return params


def mlp_apply(params: Mapping[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    n = len(params) // 2
    h = x
    for i in range(n):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            h = F.relu(h)
    return h


def loss_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                    reduce: bool = True) -> torch.Tensor:
    """Softmax cross-entropy per sample (mean when `reduce`): the loss the
    local-SGD solver takes, as the JAX package's benchmarks define it."""
    lse = torch.logsumexp(logits, dim=-1)
    per = lse - torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return per.mean() if reduce else per


def softmax_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy: logsumexp less the labelled logit."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (lse - picked).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The fraction of rows whose argmax is the label, as float32."""
    return (logits.argmax(-1) == labels).to(torch.float32).mean()


def params_from_numpy(tree: Mapping[str, np.ndarray], device="cuda"
                      ) -> Params:
    """The JAX package's CNN or MLP parameter dict (numpy leaves) as the
    port's: conv weights HWIO -> OIHW, and `f1`'s rows from the JAX
    package's HWC flatten order to CHW.  Other leaves carry over as they
    are."""
    out = {}
    for name, leaf in tree.items():
        a = np.array(leaf, np.float32)  # a private, writable copy
        if name in ("c1", "c2"):
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif name == "f1" and "c2" in tree:
            c2 = np.shape(tree["c2"])[3]
            side = math.isqrt(a.shape[0] // c2)
            a = a.reshape(side, side, c2, -1).transpose(2, 0, 1, 3)
            a = a.reshape(side * side * c2, -1)
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
