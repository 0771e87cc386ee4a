"""The port's launcher layer against the JAX package's, the
`tests/test_launch.py` cases that have a one-card counterpart: head
layouts for every arch, `decode_geometry` for every arch x input shape,
and `input_specs` for all 40 pairs — every argument's shape and dtype
equal to the reference's ShapeDtypeStruct leaf by leaf, every spec equal
to `tuple(P)` of the reference's sharding, under the host mesh and the
16x16 and 2x16x16 production meshes (and decode under `inference_2d`) —
and `build_step` giving each kind's step.

Trees are compared by path ("0/blocks/attn/wq", "1/mu/embed", ...); the
reference's `input_specs` builds specs in place of NamedShardings with
`NamedSharding` patched to return the spec (its production meshes are
namespace stubs: its rules read only axis names and sizes).  Exact: no
tolerance.
"""
import numpy as np
import pytest

from repro.configs import INPUT_SHAPES, TrainConfig, get_config, list_archs
from repro.launch import steps as JS
from repro.models.attention import head_layout, head_maps
from repro.sharding import AxisRules as JAxisRules
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import steps as TS
from repro_torch.models.attention import head_layout as t_head_layout
from repro_torch.models.attention import head_maps as t_head_maps
from repro_torch.sharding import AxisRules
from test_torch_sharding import (MESHES, P, jax_mesh, jleaves, port_mesh,
                                 sds, specs, tleaves)

ARCHS = [a for a in list_archs() if not a.startswith("chicle")]


def test_head_layouts_match_reference():
    for arch in ARCHS:
        cfg, tcfg = get_config(arch), t_get_config(arch)
        if cfg.is_attention_free():
            continue
        assert t_head_layout(tcfg) == head_layout(cfg), arch
        kind, hp, _ = t_head_layout(tcfg)
        assert hp % 16 == 0, arch
        idx, mask = t_head_maps(tcfg)
        jidx, jmask = head_maps(cfg)
        assert np.array_equal(idx.numpy(), np.asarray(jidx)), arch
        assert np.array_equal(mask.numpy(), np.asarray(jmask)), arch
        assert int(mask.sum()) == cfg.num_heads, arch


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_decode_geometry_matches_reference(shape_name):
    shape = INPUT_SHAPES[shape_name]
    for arch in ARCHS:
        assert TS.decode_geometry(t_get_config(arch), shape) == \
            JS.decode_geometry(get_config(arch), shape), arch
    # the reference test's policy cases
    geo = TS.decode_geometry(t_get_config("rwkv6-1.6b"),
                             INPUT_SHAPES["long_500k"])
    assert geo["cache_len"] == 1
    geo = TS.decode_geometry(t_get_config("qwen3-4b"),
                             INPUT_SHAPES["long_500k"])
    assert geo["variant"] == "swa-variant" and geo["cache_len"] == 4096


def _ref_specs(arch, shape, mesh, inference_2d, tc):
    rules = JAxisRules(jax_mesh(mesh), inference_2d=inference_2d)
    return JS.input_specs(get_config(arch), shape, rules, tc)


@pytest.mark.parametrize("mesh", MESHES + ["16x16-2d"])
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_input_specs_match_reference(shape_name, mesh, monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda m, s: s)
    shape = INPUT_SHAPES[shape_name]
    mesh, _, d2 = mesh.partition("-")
    inference_2d = bool(d2) and shape.kind == "decode"
    for arch in ARCHS:
        for opt in (("sgdm", "adamw") if shape.kind == "train"
                    else ("sgdm",)):
            ref = _ref_specs(arch, shape, mesh, inference_2d,
                             TrainConfig(optimizer=opt))
            got = TS.input_specs(
                t_get_config(arch), shape,
                AxisRules(port_mesh(mesh), inference_2d=inference_2d),
                TTrainConfig(optimizer=opt))
            assert got["kind"] == ref["kind"] == shape.kind
            for key in ("window", "ring", "variant"):
                assert got.get(key) == ref.get(key), (arch, key)
            targs = {f"{i}/{k}": v for i, a in enumerate(got["args"])
                     for k, v in tleaves(a).items()}
            tspecs = {f"{i}/{k}": v for i, s in enumerate(got["in_specs"])
                      for k, v in tleaves(s).items()}
            # a bare spec or tensor argument is its own leaf ("2", "3")
            targs = {k.rstrip("/"): v for k, v in targs.items()}
            tspecs = {k.rstrip("/"): v for k, v in tspecs.items()}
            assert sds(targs) == sds(jleaves(ref["args"])), arch
            assert all(t.device.type == "meta" for t in targs.values())
            assert specs(tspecs) == specs(jleaves(ref["in_shardings"], P)), \
                arch


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_step_gives_each_kind(kind):
    name = {"train": "train_4k", "prefill": "prefill_32k",
            "decode": "decode_32k"}[kind]
    spec = TS.input_specs(t_get_config("qwen3-4b"), INPUT_SHAPES[name],
                          AxisRules(port_mesh("host")))
    step = TS.build_step(t_get_config("qwen3-4b"), spec)
    assert step.__name__ == {"train": "train_step",
                             "prefill": "prefill_step",
                             "decode": "serve_step"}[kind]
