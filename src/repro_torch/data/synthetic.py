"""Synthetic dataset generators (offline stand-ins for CIFAR-10 / Fashion-
MNIST / HIGGS / Criteo): numpy, the same draws as the JAX package's
`data/synthetic.py` for the same seeds."""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def make_classification(n: int, n_features: int, n_classes: int,
                        *, seed: int = 0, noise: float = 1.0,
                        pattern_seed: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian-blob multi-class data (linearly separable-ish)."""
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(pattern_seed).normal(
        size=(n_classes, n_features)) * 2.0
    y = rng.integers(0, n_classes, size=n)
    x = centers[y] + rng.normal(size=(n, n_features)) * noise
    return x.astype(np.float32), y.astype(np.int32)


def make_svm_data(n: int, n_features: int, *, seed: int = 0,
                  noise: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Binary data with labels in {-1, +1} for the SVM/CoCoA workload."""
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(11).normal(size=n_features)
    x = rng.normal(size=(n, n_features))
    margin = x @ w_true / np.sqrt(n_features)
    y = np.sign(margin + rng.normal(size=n) * noise)
    y[y == 0] = 1.0
    # normalize rows (standard for SDCA step sizes)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-6)
    return x.astype(np.float32), y.astype(np.float32)


def make_images(n: int, size: int, channels: int, n_classes: int,
                *, seed: int = 0, noise: float = 0.6, pattern_seed: int = 7
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-dependent spatial patterns + noise (CIFAR-like stand-in).

    pattern_seed fixes the class prototypes so train/test splits drawn with
    different `seed`s share the same underlying concept.
    """
    rng = np.random.default_rng(seed)
    patterns = np.random.default_rng(pattern_seed).normal(
        size=(n_classes, size, size, channels))
    y = rng.integers(0, n_classes, size=n)
    x = patterns[y] * 0.8 + rng.normal(size=(n, size, size, channels)) * noise
    return x.astype(np.float32), y.astype(np.int32)


def make_lm_tokens(n_seqs: int, seq_len: int, vocab: int, *, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Markov-ish token streams so an LM has learnable structure."""
    rng = np.random.default_rng(seed)
    # low-entropy transition structure: each token prefers a few successors
    nxt = rng.integers(0, vocab, size=(vocab, 4))
    toks = np.zeros((n_seqs, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        choice = rng.integers(0, 4, size=n_seqs)
        explore = rng.random(n_seqs) < 0.1
        step = nxt[toks[:, t], choice]
        toks[:, t + 1] = np.where(explore, rng.integers(0, vocab, n_seqs), step)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
