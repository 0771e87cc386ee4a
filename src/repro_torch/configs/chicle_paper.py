"""Configs for the paper's own workloads (Chicle §5).

The paper trains (i) a small CNN (2 conv + maxpool + 3 FC) on CIFAR-10 /
Fashion-MNIST with local SGD, and (ii) an SVM on HIGGS / Criteo with CoCoA+SCD.
We reproduce both on synthetic datasets with the same sample/feature scales
reduced to CPU-laptop size (the algorithmic claims C1-C6 are scale-free).
"""
from dataclasses import dataclass

from .base import TrainConfig


@dataclass(frozen=True)
class CNNConfig:
    """Paper's CNN: 2x(conv relu maxpool) + 3 FC, relu."""

    name: str = "chicle-cnn"
    image_size: int = 16  # reduced CIFAR stand-in
    channels: int = 3
    conv_channels: tuple = (16, 32)
    fc_sizes: tuple = (128, 64)
    num_classes: int = 10


@dataclass(frozen=True)
class GLMConfig:
    """Paper's SVM-via-CoCoA workload (hinge loss, L2 reg, dual SCD solver)."""

    name: str = "chicle-svm"
    num_features: int = 256
    lambda_reg: float = 0.01  # paper: lambda = 0.01 * n (we use per-sample form)
    sigma: float = 0.0  # 0 -> set to K at runtime (paper: sigma' = K)


# Paper hyper-parameters (§5.1): L=8, H=16, momentum 0.9, lr 1e-4 (CIFAR-10)
PAPER_LSGD = TrainConfig(
    local_batch=8,
    local_steps=16,
    learning_rate=1e-4,
    momentum=0.9,
    scale_lr_sqrt_k=True,
    optimizer="sgdm",
)

PAPER_MSGD = TrainConfig(
    local_batch=8,
    local_steps=1,
    learning_rate=0.002,  # appendix A.1 baseline comparison
    momentum=0.9,
    scale_lr_sqrt_k=False,
    optimizer="sgdm",
)
