"""The port's package surface matches the JAX package's: every name the
JAX package's `repro.serve`, `repro.models` and `repro.cluster` export
imports from `repro_torch.serve`, `repro_torch.models` and
`repro_torch.cluster`, and each port `__all__` lists it, the sharding
names of `repro.models` (parameter and cache specs and shape stand-ins,
the parameter count) included."""
import importlib

import pytest

import repro.cluster
import repro.models
import repro.serve


@pytest.mark.parametrize("package", ["serve", "models", "cluster"])
def test_every_reference_export_imports_from_the_port(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    want = set(ref.__all__)
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, missing
    assert want <= set(port.__all__)
    # each exported name is the port's own object, not the reference's
    for name in want:
        obj = getattr(port, name)
        mod = getattr(obj, "__module__", None) or getattr(obj, "__name__")
        assert mod.startswith("repro_torch"), (name, mod)
