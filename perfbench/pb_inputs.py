"""The benchmark's inputs, made from the seed on the device: an LM's
weights and token rows, a GLM's rows and labels; and the worker schedule
of a traffic mix.  The program and the
plain reference are handed the same tensors, made by these functions and
nothing of the program.

Each seed draws one `torch.Generator` per input on the device, so the
reference can make the same input again after the program is gone."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

# per-input offsets of the generator seed, so no two inputs share a stream
_WEIGHTS, _TOKENS, _ROWS, _LABELS = (0x5EED0001, 0x5EED0002, 0x5EED0003,
                                     0x5EED0004)


def generator(torch, seed: int, which: int, device):
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 0x9E3779B1 + which) % (1 << 63))


def worker_schedule(traffic: Dict) -> List[int]:
    """The Chicle worker count of each step (iteration) of one period of a
    traffic mix's `workers`: [[K, steps held], ...]."""
    return [k for k, n in traffic["workers"] for _ in range(n)]


def lm_layout(c: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The dense GQA decoder's leaves as (path, shape, init), blocks stacked
    along a leading layer dim: the layout of the port's parameter tree
    (the system module checks it against the program's)."""
    D, L = c["hidden_size"], c["num_hidden_layers"]
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    Fd, V = c["intermediate_size"], c["vocab_size"]
    return [
        ("blocks/attn/wk", (L, D, KV, hd), f"normal:{D}"),
        ("blocks/attn/wo", (L, H, hd, D), f"normal:{H * hd}"),
        ("blocks/attn/wq", (L, D, H, hd), f"normal:{D}"),
        ("blocks/attn/wv", (L, D, KV, hd), f"normal:{D}"),
        ("blocks/ln1", (L, D), "ones"),
        ("blocks/ln2", (L, D), "ones"),
        ("blocks/mlp/down", (L, Fd, D), f"normal:{Fd}"),
        ("blocks/mlp/gate", (L, D, Fd), f"normal:{D}"),
        ("blocks/mlp/up", (L, D, Fd), f"normal:{D}"),
        ("embed", (V, D), "small"),
        ("final_ln", (D,), "ones"),
    ]


def lm_weights(torch, c: Dict, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """All leaves as views of one buffer in the served dtype, drawn by one
    `randn` call and scaled leaf by leaf: N(0, 1/fan_in) for projections
    (fan_in their contraction width), N(0, 0.02^2) for the embedding, ones
    for the norm scales."""
    dtype = getattr(torch, c["torch_dtype"])
    layout = lm_layout(c)
    total = sum(math.prod(s) for _, s, _ in layout)
    flat = torch.randn(total, generator=generator(torch, seed, _WEIGHTS,
                                                  device),
                       dtype=dtype, device=device)
    out, off = {}, 0
    for path, shape, init in layout:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        off += n
        if init == "ones":
            leaf.fill_(1.0)
        elif init == "small":
            leaf.mul_(0.02)
        else:
            leaf.mul_(1.0 / math.sqrt(int(init.split(":")[1])))
        out[path] = leaf
    return out


def lm_tokens(torch, c: Dict, n_seqs: int, seq_len: int, seed: int, device):
    """(n_seqs, seq_len + 1) int32 token rows, uniform over the vocabulary,
    on the host as numpy: a row's tokens are its first seq_len entries,
    its labels the last seq_len."""
    g = generator(torch, seed, _TOKENS, device)
    t = torch.randint(0, c["vocab_size"], (n_seqs, seq_len + 1), generator=g,
                      dtype=torch.int32, device=device)
    return t.cpu().numpy()


def glm_rows(torch, c: Dict, seed: int, device):
    """The GLM's rows X (n, F) float32 of unit norm and labels y (n,) in
    {-1, +1}: Gaussian rows, labels the sign of a planted separator's
    margin plus Gaussian noise (`label_noise`), as `make_svm_data` draws
    them.  X and the separator come from one generator, the noise from
    another."""
    n, F = c["n_samples"], c["n_features"]
    gx = generator(torch, seed, _ROWS, device)
    gy = generator(torch, seed, _LABELS, device)
    w_true = torch.randn(F, generator=gx, dtype=torch.float32, device=device)
    x = torch.randn(n, F, generator=gx, dtype=torch.float32, device=device)
    noise = torch.randn(n, generator=gy, dtype=torch.float32, device=device)
    margin = torch.mv(x, w_true) / math.sqrt(F)
    y = torch.where(margin + c["label_noise"] * noise >= 0, 1.0, -1.0)
    x /= x.norm(dim=1, keepdim=True).clamp_min(1e-6)
    return x, y
