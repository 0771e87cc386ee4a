"""The port's sharding rules and the model API's sharding names against
the JAX package, for every arch: `count_params`, `param_sds`/`cache_sds`
(shapes and dtypes), `param_specs`/`cache_specs` (each spec equal to
`tuple(P)`) under the host mesh and the reference's 16x16 and 2x16x16
production meshes, `AxisRules.guard` of uneven dims (the counterpart of
`tests/test_substrate.py::test_axis_rules_guard_uneven`), `shard_shape`,
and the planner's per-device argument bytes on the production meshes
against the sum over the reference's own ShapeDtypeStructs and specs.

The reference's `AxisRules` reads only `mesh.axis_names` and `mesh.shape`
in `spec`/`guard`, so a namespace stub stands in for its 256- and
512-device meshes, and its `input_specs` builds specs in place of
NamedShardings with `NamedSharding` patched to return the spec.
Everything is exact: no tolerance.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import INPUT_SHAPES, get_config, list_archs
from repro.launch import mesh as JMesh
from repro.launch import steps as JS
from repro.models import model as JM
from repro.sharding import AxisRules as JAxisRules
from repro_torch.configs import get_config as t_get_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import mesh as TMesh
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import OptState
from repro_torch.sharding import AxisRules, Mesh, shard_shape

ARCHS = [a for a in list_archs() if not a.startswith("chicle")]
MESHES = ["host", "16x16", "2x16x16"]


def jax_mesh(name):
    if name == "host":
        return JMesh.make_host_mesh()
    names = ("data", "model") if name == "16x16" else ("pod", "data",
                                                      "model")
    sizes = tuple(int(s) for s in name.split("x"))
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def port_mesh(name) -> Mesh:
    if name == "host":
        return TMesh.make_host_mesh()
    return TMesh.make_production_mesh(multi_pod=name == "2x16x16")


def _key(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def jleaves(tree, leaf=None):
    """{"a/b/c": leaf} of a JAX pytree (P leaves with leaf=P)."""
    is_leaf = (lambda x: isinstance(x, leaf)) if leaf else None
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_key(k) for k in path): x for path, x in flat}


def tleaves(tree, prefix=""):
    """{"a/b/c": leaf} of the port's trees: modules by param path,
    OptStates by field, dicts by key; tensors and spec tuples are
    leaves."""
    if isinstance(tree, torch.nn.Module):
        return {prefix + k: v for k, v in TM.param_dict(tree).items()}
    if isinstance(tree, OptState):
        tree = {f: v for f, v in zip(tree._fields, tree) if v is not None}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tleaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def sds(leaves):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in leaves.items()}


def specs(leaves):
    return {k: tuple(v) for k, v in leaves.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_sds_match_reference(arch):
    cfg, tcfg = get_config(arch), t_get_config(arch)
    assert TM.count_params(tcfg) == JM.count_params(cfg)
    got = sds(tleaves(TM.param_sds(tcfg)))
    assert got == sds(jleaves(JM.param_sds(cfg)))
    assert all(t.device.type == "meta"
               for t in tleaves(TM.param_sds(tcfg)).values())
    B, L, X = 3, 40, JS.memory_len(cfg)
    assert sds(tleaves(TM.cache_sds(tcfg, B, L, cross_len=X))) == \
        sds(jleaves(JM.cache_sds(cfg, B, L, cross_len=X)))


@pytest.mark.parametrize("mesh", MESHES)
def test_param_and_cache_specs_match_reference(mesh):
    rules = AxisRules(port_mesh(mesh))
    jrules = JAxisRules(jax_mesh(mesh))
    for arch in ARCHS:
        cfg, tcfg = get_config(arch), t_get_config(arch)
        assert specs(tleaves(TM.param_specs(tcfg, rules))) == \
            specs(jleaves(JM.param_specs(cfg, jrules), P)), arch
        assert specs(tleaves(TM.cache_specs(tcfg, rules))) == \
            specs(jleaves(JM.cache_specs(cfg, jrules), P)), arch


def test_meshes_match_reference():
    assert TMesh.make_host_mesh().shape == dict(JMesh.make_host_mesh().shape)
    for mp, name in ((False, "16x16"), (True, "2x16x16")):
        m = TMesh.make_production_mesh(multi_pod=mp)
        ref = jax_mesh(name)
        assert m.axis_names == ref.axis_names and m.shape == ref.shape
        assert m.name == name
        assert TMesh.mesh_chips(m) == int(np.prod(list(ref.shape.values())))
    assert TMesh.make_host_mesh(data=2).shape == {"data": 2}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("inference_2d", [False, True], ids=["", "2d"])
def test_axis_rules_match_reference(mesh, inference_2d):
    rules = AxisRules(port_mesh(mesh), inference_2d=inference_2d)
    jrules = JAxisRules(jax_mesh(mesh), inference_2d=inference_2d)
    for ax in ("batch", "cache_batch", "fsdp", "tensor", "seq"):
        assert getattr(rules, ax) == getattr(jrules, ax), ax
        assert rules.axis_size(getattr(rules, ax)) == \
            jrules.axis_size(getattr(jrules, ax))
    axes = ("batch", "fsdp", "tensor", "cache_batch", "seq", None)
    assert rules.spec(*axes) == tuple(jrules.spec(*axes))
    for shape in [(7, 4), (16, 48), (32, 15), (512, 3, 64)]:
        for spec in [("data", None), (("pod", "data"), "model"),
                     (None, "model", "model"), ("model",)]:
            if any(a not in rules.axis_names
                   for s in spec if s for a in ((s,) if isinstance(s, str)
                                                 else s)):
                continue
            assert rules.guard(spec, shape) == \
                tuple(jrules.guard(P(*spec), shape)), (spec, shape)
    with pytest.raises(ValueError):
        rules.spec("nonsense")


def test_axis_rules_guard_uneven():
    """tests/test_substrate.py::test_axis_rules_guard_uneven on the
    port: a single-device mesh drops everything to None; 16 shards keep
    only the dims they divide."""
    rules = AxisRules(TMesh.make_host_mesh())
    assert rules.guard(("data", None), (7, 4)) == (None, None)
    prod = AxisRules(TMesh.make_production_mesh())
    assert prod.guard(("data", "model"), (7, 32)) == (None, "model")
    assert prod.guard((("data",), None), (48,)) == ("data",)
    assert prod.guard((("data", "model"), None), (512, 3)) == \
        (("data", "model"), None)


def test_shard_shape():
    mesh = TMesh.make_production_mesh(multi_pod=True)
    assert shard_shape((64, 48, 5), (("pod", "data"), "model", None),
                       mesh) == (2, 3, 5)
    assert shard_shape((7,), (), mesh) == (7,)
    with pytest.raises(ValueError):
        shard_shape((7, 4), ("data", None), mesh)


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
def test_per_device_argument_bytes_match_reference(mesh, shape_name,
                                                   monkeypatch):
    """The planner's per-device argument bytes == the sum over the
    reference's input_specs args of each SDS's shard under its spec."""
    monkeypatch.setattr(JS, "NamedSharding", lambda m, s: s)
    jm, tm = jax_mesh(mesh), port_mesh(mesh)
    shape = INPUT_SHAPES[shape_name]
    for arch in ARCHS:
        ref = JS.input_specs(get_config(arch), shape, JAxisRules(jm))
        a = jleaves(ref["args"])
        s = jleaves(ref["in_shardings"], P)
        want = 0
        for k, x in a.items():
            dims = shard_shape(tuple(x.shape), tuple(s[k]), tm)
            want += int(np.prod(dims)) * x.dtype.itemsize
        got = TD.per_device_bytes(
            TS.input_specs(t_get_config(arch), shape, AxisRules(tm)), tm)
        assert got == want, arch
