"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
`chip_smoke.py` imports nothing of the JAX package, the engine and the
training solvers run on the GPU unless the caller asks for the CPU, and a
kernel build without nvcc raises instead of handing back the plain
version."""
import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

import repro_torch
from repro_torch.configs import get_config, smoke_variant
from repro_torch.configs.chicle_paper import PAPER_LSGD
from repro_torch.core import ChunkStore, CoCoASolver, LocalSGDSolver
from repro_torch.core.nets import loss_per_sample, mlp_apply
from repro_torch.kernels import build as build_mod
from repro_torch.faults import FaultInjector, FaultPlan, worker_crash
from repro_torch.serve import ServeEngine, synthetic_requests

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_roots(path: Path):
    """Top-level names of every module the file imports (absolute imports;
    relative ones stay inside the package)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_every_module_imports_without_jax_or_repro():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.serve.engine" in modules
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now fails
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None "
        "and m.split('.')[0] in ('repro', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_name_no_jax_or_repro():
    for path in PORT.rglob("*.py"):
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_chip_smoke_imports_nothing_of_the_jax_package():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.mark.parametrize("name", ["cluster_mix_torch", "cocoa_svm_torch",
                                  "load_balancing_torch",
                                  "quickstart_torch",
                                  "train_elastic_lm_torch",
                                  "elastic_remesh_torch",
                                  "serve_decode_torch",
                                  "disagg_serve_torch"])
def test_torch_examples_import_nothing_of_the_jax_package(name):
    roots = _imported_roots(ROOT / "examples" / f"{name}.py")
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_engine_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_variant(get_config("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, kv_layout="paged")


@pytest.mark.parametrize("kw", [dict(arch="rwkv6-1.6b")])
def test_unported_options_raise(kw):
    """A model family the engine does not serve raises, as the JAX
    package's engine does: the ssm family runs through prefill and
    decode_step, not the engine (every ServeEngine keyword is ported)."""
    cfg = smoke_variant(get_config(kw["arch"]))
    with pytest.raises(NotImplementedError, match="ServeEngine supports"):
        ServeEngine(cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(brownout="auto"),
    dict(fault_injector=FaultInjector(FaultPlan([worker_crash(0)]))),
    dict(queue_cap=4), dict(overlap=True), dict(decode_enabled=False)])
def test_now_ported_options_construct(kw):
    """Options that raised before faults, overload control, the
    overlapped tick and disaggregated serving were ported build an engine
    on the CPU that ticks."""
    cfg = smoke_variant(get_config("smollm-360m"))
    eng = ServeEngine(cfg, device="cpu", kv_layout="paged", n_workers=2,
                      capacity=2, cache_len=16, prefill_bucket=8, **kw)
    eng.submit(synthetic_requests(2, vocab_size=cfg.vocab_size,
                                  arrivals=np.zeros(2), prompt_len=(4, 6),
                                  max_new_tokens=(2, 3),
                                  rng=np.random.default_rng(0)))
    rec = eng.tick()
    assert rec.tick == 0 and eng._tick == 1
    if "fault_injector" in kw:
        assert rec.crashes == 1 and eng.k == 1
    if "brownout" in kw:
        assert eng.ladder is not None and rec.brownout_level == 0
    if "queue_cap" in kw:
        assert eng.scheduler.admission.enabled
    if "overlap" in kw:
        assert eng.overlap and rec.admitted == 2
    if "decode_enabled" in kw:  # a prefill pool: prefills, never decodes
        assert rec.admitted == 2 and rec.tokens_emitted == 0
        assert len(eng._by_slot) + len(eng._prefilling) == 2


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build_mod, "_loaded", {})
    with pytest.raises(build_mod.KernelBuildError, match="nvcc"):
        build_mod.build("paged_attention")


@pytest.mark.parametrize("kernel", ["scd", "chunk_reduce",
                                    "flash_attention"])
def test_training_kernel_builds_raise_without_nvcc(monkeypatch, tmp_path,
                                                   kernel):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build_mod, "_loaded", {})
    with pytest.raises(build_mod.KernelBuildError, match="nvcc"):
        build_mod.build(kernel)


SCANNED_MODULES = ["faults", "core.cocoa", "core.local_sgd", "core.nets",
                    "core.engine", "core.metrics", "data.synthetic",
                    "kernels.scd", "kernels.chunk_reduce", "kernels.ops",
                    "kernels.flash_attention", "data.pipeline",
                    "optim.optimizers", "optim.schedule", "launch.steps",
                    "launch.train", "launch.elastic", "checkpoint.ckpt",
                    "cluster.trace", "cluster.allocator", "cluster.pool",
                    "cluster.jobs", "cluster.orchestrator", "cluster",
                    "models.ssm", "models.transformer", "models.model"]


@pytest.mark.parametrize("module", SCANNED_MODULES)
def test_training_modules_import_neither_jax_nor_repro(module):
    path = PORT / (module.replace(".", "/") + ".py")
    if not path.is_file():  # a package: its __init__
        path = PORT / module.replace(".", "/") / "__init__.py"
    assert path.is_file(), path
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def _solver(name, **kw):
    x = np.zeros((8, 4), np.float32)
    y = np.ones(8, np.float32)
    if name == "cocoa":
        return CoCoASolver(ChunkStore({"x": x, "y": y}, chunk_size=4), **kw)
    params = {"w0": torch.zeros(4, 2), "b0": torch.zeros(2)}
    return LocalSGDSolver(params, mlp_apply, loss_per_sample, PAPER_LSGD,
                          **kw)


@pytest.mark.parametrize("name", ["cocoa", "lsgd"])
def test_training_solvers_default_to_cuda_and_refuse_without_it(
        monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _solver(name)
    assert _solver(name, device="cpu").device.type == "cpu"


def test_lm_trainer_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    from repro_torch.configs import TrainConfig
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.elastic import ElasticTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_train.train("h2o-danube-1.8b", smoke=True, train_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticTrainer(smoke_variant(get_config("h2o-danube-1.8b")),
                       TrainConfig())


@pytest.mark.parametrize("fn", ["models.model", "core.nets"])
def test_params_from_numpy_defaults_to_cuda(fn):
    import importlib
    import inspect
    mod = importlib.import_module(f"repro_torch.{fn}")
    sig = inspect.signature(mod.params_from_numpy)
    assert sig.parameters["device"].default == "cuda"


def _cluster_ctor(name, **kw):
    """Build one of the cluster's device-holding objects at smoke size;
    `kw` is the device keyword, or nothing for the default."""
    from repro_torch import cluster as C
    from repro_torch.configs import TrainConfig
    cfg = smoke_variant(get_config("smollm-360m"))
    spec = C.JobSpec(name, "serve" if "serve" in name else "train")
    if name == "pool":
        return C.DevicePool(2, **kw)
    if name == "cocoa_train_job":
        return C.cocoa_train_job("t", iterations=1, k_tasks=2, n=40, f=4,
                                 chunk=10, **kw)
    if name == "lm_train_job":
        return C.LMTrainJob(spec, cfg, TrainConfig(), batch_fn=dict,
                            steps=1, **kw)
    if name == "serve_job":
        return C.ServeJob(spec, cfg, capacity=2, cache_len=16, **kw)
    return C.DisaggServeJob(spec, cfg, capacity=2, cache_len=16, **kw)


@pytest.mark.parametrize("name", ["pool", "cocoa_train_job", "lm_train_job",
                                  "serve_job", "disagg_serve_job"])
def test_cluster_defaults_to_cuda_and_refuses_without_it(monkeypatch, name):
    """The pool lists the CUDA devices and each job builds its engine,
    solver or trainer on CUDA unless told otherwise; without a card they
    raise, and with the CPU named they build there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _cluster_ctor(name)
    kw = (dict(devices=[torch.device("cpu")]) if name == "pool"
          else dict(device="cpu"))
    obj = _cluster_ctor(name, **kw)
    if name == "pool":
        assert obj.devices == [torch.device("cpu")] * 2
    elif name == "cocoa_train_job":
        assert obj.solver.device.type == "cpu"
    elif name == "lm_train_job":
        assert obj.trainer.devices == [torch.device("cpu")]
    else:
        eng = obj.engine
        for half in ([eng.prefill, eng.decode] if hasattr(eng, "prefill")
                     else [eng]):
            assert half.device.type == "cpu"
