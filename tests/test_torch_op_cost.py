"""The port's op counter (`launch/op_cost.py`) and roofline
(`launch/roofline.py`) against the JAX package's HLO cost model
(`launch/hlo_cost.py`) and `launch/hlo_analysis.py`.

- a Python loop of 5 matmuls counts 5 (the counterpart of
  `tests/test_substrate.py::test_hlo_cost_counts_while_bodies`);
- exact bytes and live memory for a hand-built sequence of ops;
- the prefill and the flat decode step of every arch's smoke variant,
  traced on meta tensors, count exactly the flops that `hlo_cost.analyze`
  reads from the reference's compiled step (B 2, S 64; decode on a
  128-row cache);
- the train step at remat=False: equal flops for eight archs; for rwkv6
  and jamba the test names the ops that differ and the difference equals
  their flops;
- `model_flops_for` and `roofline_terms` equal the reference's, its
  constants set to the H100's.
Exact: no tolerance.
"""
import jax
import pytest
import torch

from repro.configs import TrainConfig, get_config, list_archs, smoke_variant
from repro.launch import hlo_analysis as JH
from repro.launch import hlo_cost
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.sharding import AxisRules as JAxisRules
from repro_torch.configs import ShapeConfig
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_variant as t_smoke_variant
from repro_torch.launch import dryrun as TD
from repro_torch.launch import roofline as TR
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import transformer as tfm
from repro_torch.sharding import AxisRules

ARCHS = [a for a in list_archs() if not a.startswith("chicle")]
SHAPES = {"prefill": ShapeConfig("prefill_64", 64, 2, "prefill"),
          "decode": ShapeConfig("decode_128", 128, 2, "decode"),
          "train": ShapeConfig("train_64", 64, 2, "train")}


def test_counts_every_trip_of_a_loop():
    for device in ("cpu", "meta"):
        x = torch.ones(8, 8, device=device)
        with OpCost() as c:
            y = x
            for _ in range(5):
                y = y @ x
        assert c.flops == 5 * 2 * 8 * 8 * 8
        assert c.by_op["mm"].count == 5
        assert c.by_op["mm"].flops == c.flops


def test_exact_bytes_and_memory():
    x, w, b = torch.ones(4, 8), torch.ones(8, 16), torch.ones(16)
    c = OpCost()
    c.hold((x, w, b))
    with c:
        y = torch.addmm(b, x, w)  # reads 16 + 32 + 128, writes 64 floats
        z = y.view(8, 8)  # an alias: nothing
        r = torch.relu(z)  # reads 64, writes 64
        r.add_(1.0)  # self read and written
        d = r.detach()  # an alias: nothing
        del y, z
    assert c.flops == 2 * 4 * 16 * 8
    assert c.by_op["addmm"].bytes == 4 * (16 + 32 + 128 + 64)
    assert c.by_op["relu"].bytes == 4 * 128
    assert c.by_op["add_"].bytes == 4 * 128
    assert c.by_op["view"].bytes == c.by_op["detach"].bytes == 0
    assert c.bytes == 4 * (240 + 128 + 128)
    assert c.peak_bytes == 2 * 64 * 4  # y and r alive together
    assert c.live_bytes == 64 * 4  # y died; r (and its alias d) lives
    assert c.new_bytes((d, x)) == 64 * 4
    assert c.produced[("relu", "float32", (8, 8))] == [256, 1]


def ref_flops(arch, kind, tc=None):
    cfg = smoke_variant(get_config(arch))
    rules = JAxisRules(j_host_mesh())
    spec = JS.input_specs(cfg, SHAPES[kind], rules, tc)
    step = JS.build_step(cfg, SHAPES[kind], rules, spec)
    hlo = jax.jit(step).lower(*spec["args"]).compile().as_text()
    return hlo_cost.analyze(hlo).flops


def port_flops(arch, kind, tc=None):
    cfg = t_smoke_variant(t_get_config(arch))
    spec = TS.input_specs(cfg, SHAPES[kind], AxisRules(make_host_mesh()), tc)
    cost, _, _ = TD.trace(cfg, spec)
    return cost.flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_inference_flops_match_reference(arch, kind):
    assert port_flops(arch, kind) == ref_flops(arch, kind)


def named_train_difference(arch) -> float:
    """Port minus reference flops of the remat=False train step, by the
    ops that differ; 0 where none does."""
    cfg = t_smoke_variant(t_get_config(arch))
    B, S = SHAPES["train"].global_batch, SHAPES["train"].seq_len
    if cfg.family == "ssm":
        H, hd, c = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim, 64
        L = cfg.num_layers
        # torch skips the gradient of the inter-chunk product r_dec @ s
        # for the zero initial state s (it takes no gradient): one
        # (B*H) x c x hd x hd bmm a layer that XLA runs
        skipped = L * 2 * B * H * c * hd * hd
        # the 'bchk,bchk->bch' bonus contraction's backward: two
        # batched products a layer in torch, multiplies in XLA
        bonus = L * 2 * (2 * B * S * H * hd)
        return bonus - skipped
    if cfg.family == "hybrid":
        di, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim
        dtr = max(16, cfg.d_model // 16)  # mamba's dt rank
        n_mamba = tfm.n_blocks(cfg) * (cfg.attn_every - 1)
        # torch.utils.checkpoint of the mamba chunk body recomputes its
        # products in backward; the compiled reference does not:
        # x_proj, dt_proj and the C contraction 'bcdn,bcn->bcd'
        recompute = (2 * B * S * di * (dtr + 2 * n) + 2 * B * S * dtr * di
                     + 2 * B * S * di * n)
        return n_mamba * recompute
    return 0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_flops_match_reference(arch):
    got = port_flops(arch, "train", TTrainConfig(remat=False))
    want = ref_flops(arch, "train", TrainConfig(remat=False))
    assert got - want == named_train_difference(arch)


def test_roofline_matches_reference(monkeypatch):
    """The reference's terms on one chip (no collective bytes), with its
    constants patched to the H100's: the port's row is the reference's
    without the collective term."""
    monkeypatch.setattr(JH, "PEAK_FLOPS", TR.PEAK_FLOPS["bfloat16"])
    monkeypatch.setattr(JH, "HBM_BW", TR.HBM_BW)
    for kw in (dict(flops=3.5e15, bytes_accessed=2e12, model_flops=2e15),
               dict(flops=1e12, bytes_accessed=7e12, model_flops=3e14)):
        got = TR.roofline_terms(**kw).row()
        want = JH.roofline_terms(
            hlo_flops=kw["flops"], hlo_bytes=kw["bytes_accessed"],
            collective_bytes=0.0, chips=1,
            model_flops=kw["model_flops"]).row()
        assert got.pop("bound_s") == max(want["compute_s"],
                                         want["memory_s"])
        assert (want.pop("collective_bytes"), want.pop("chips"),
                want.pop("collective_s")) == (0.0, 1, 0.0)
        assert got == want
    fp32 = TR.roofline_terms(flops=67e12, bytes_accessed=0.0,
                             model_flops=0.0, dtype="float32")
    assert fp32.compute_s == 1.0 and fp32.bottleneck == "compute"


def test_model_flops_match_reference():
    from repro.configs import INPUT_SHAPES
    for arch in ARCHS:
        for shape in INPUT_SHAPES.values():
            assert TR.model_flops_for(t_get_config(arch), shape) == \
                JH.model_flops_for(get_config(arch), shape), arch
