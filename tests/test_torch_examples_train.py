"""The port's training examples (examples/quickstart_torch.py,
train_elastic_lm_torch.py --quick, elastic_remesh_torch.py) on the CPU
against the bodies of the JAX examples (examples/quickstart.py,
train_elastic_lm.py --quick, elastic_remesh.py) rebuilt here: the JAX
example files are not imported, since elastic_remesh.py sets XLA_FLAGS
for 8 host devices.  The JAX initial parameters are carried across into
the port's `train` and `ElasticTrainer` by patching `init_params` on both
sides (the JAX side records its tree, the port's side converts it with
`params_from_numpy`), so both start from the same weights.

Workers, sim_time and scale events are held equal at every step; losses
at rtol 1e-4, the loop tolerance of tests/test_torch_lm_train.py.  The
largest relative loss differences measured on the CPU: 7.8e-8 over
quickstart's 30 steps, 1.6e-7 over train_elastic_lm --quick's 40 and
7.8e-8 over elastic_remesh's 32.  The printed check lines (and
elastic_remesh's RESIZED and step lines) equal the JAX example's.

Each example's `__main__` block takes --device (default cuda) and the JAX
example's switch, and each example refuses to run without a card unless
it is given the CPU.
"""
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig, get_config, smoke_variant
from repro.data import make_lm_tokens
from repro.launch import train as JT
from repro.launch.elastic import ElasticTrainer
from repro.models import model as JM
from repro_torch.models import model as TM

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ["quickstart_torch", "train_elastic_lm_torch",
         "elastic_remesh_torch", "serve_decode_torch", "disagg_serve_torch"]
RTOL = 1e-4


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def carried(monkeypatch):
    """The JAX `init_params` records its tree; the port's converts it."""
    made = {}
    real = JM.init_params

    def record(cfg, key):
        made["params"] = real(cfg, key)
        return made["params"]

    monkeypatch.setattr(JM, "init_params", record)
    monkeypatch.setattr(TM, "init_params", lambda cfg, gen, device: (
        TM.params_from_numpy(cfg, jax.tree.map(np.asarray, made["params"]),
                             device=device)))


def _jax_quickstart():
    """examples/quickstart.py's body (its check and last line)."""
    out = JT.train("smollm-360m", smoke=True, train_steps=30, global_batch=8,
                   seq_len=64, workers=4, lr=5e-3, log_every=5)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    print(f"quickstart OK: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out["history"]


def _jax_train_elastic_lm_quick():
    """examples/train_elastic_lm.py --quick's body."""
    hist = JT.train("qwen3-4b", scale="tiny", train_steps=40, global_batch=8,
                    seq_len=64, workers=8, elastic="5:8,15:2,25:6",
                    rebalance=True, lr=5e-3, log_every=5)["history"]
    workers_seen = sorted({h["workers"] for h in hist})
    print(f"worker counts during run: {workers_seen}")
    print(f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    assert len(workers_seen) >= 3
    assert hist[-1]["loss"] < hist[0]["loss"]
    print("elastic LM training OK")
    return hist


@pytest.mark.parametrize("name", ["quickstart", "train_elastic_lm"])
def test_training_example_matches_the_jax_example(name, carried, capsys):
    want = {"quickstart": _jax_quickstart,
            "train_elastic_lm": _jax_train_elastic_lm_quick}[name]()
    want_lines = capsys.readouterr().out.splitlines()
    mod = _example(f"{name}_torch")
    out = (mod.run("cpu") if name == "quickstart"
           else mod.run("cpu", quick=True))
    got = out["history"]
    lines = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    assert [h["workers"] for h in got] == [h["workers"] for h in want]
    assert [h["sim_time"] for h in got] == [h["sim_time"] for h in want]
    assert [h["events"] for h in got] == [h["events"] for h in want]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=RTOL)
    if name == "quickstart":
        assert lines[-1] == want_lines[-1]
        assert lines[-1].startswith("quickstart OK")
    else:
        assert sorted({h["workers"] for h in got}) == [2, 6, 8]
        assert lines[-3:] == want_lines[-3:]
        assert lines[-1] == "elastic LM training OK"


def _jax_elastic_remesh():
    """examples/elastic_remesh.py's body on the one CPU device."""
    cfg = smoke_variant(get_config("smollm-360m"))
    tc = TrainConfig(learning_rate=5e-3, remat=False)
    trainer = ElasticTrainer(cfg, tc)
    data = make_lm_tokens(512, 64, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    schedule = {8: 8, 16: 2, 24: 6}
    losses = []
    for step in range(32):
        if step in schedule:
            trainer.resize(schedule[step])
            print(f"step {step}: RESIZED to {trainer.k} devices "
                  f"(mesh {dict(trainer.mesh.shape)})")
        idx = rng.integers(0, 512, 8)
        batch = {"tokens": jnp.asarray(data["tokens"][idx]),
                 "labels": jnp.asarray(data["labels"][idx]),
                 "weights": jnp.ones((8,), jnp.float32)}
        m = trainer.train_step(batch)
        losses.append(m["loss"])
        if step % 8 == 0 or step == 31:
            print(f"step {step:3d} devices {trainer.k} loss {m['loss']:.4f}")
    assert losses[-1] < losses[0]
    print(f"elastic remesh OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"across device counts 8->2->6")
    return losses


def test_elastic_remesh_matches_the_jax_example(carried, capsys):
    want = _jax_elastic_remesh()
    want_lines = capsys.readouterr().out.splitlines()
    got, trainer = _example("elastic_remesh_torch").run("cpu")
    lines = capsys.readouterr().out.splitlines()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert lines == want_lines
    assert sum("RESIZED to 1 devices (mesh {'data': 1})" in ln
               for ln in lines) == 3
    assert trainer.k == 1


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_to_run_without_a_card(name, monkeypatch):
    """The default device is the card; without one the example raises as
    its entry point does and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).run()


@pytest.mark.parametrize("name,switch", [
    ("quickstart_torch", None), ("train_elastic_lm_torch", "--quick"),
    ("elastic_remesh_torch", None), ("serve_decode_torch", None),
    ("disagg_serve_torch", "--fast")])
def test_example_command_line(name, switch, monkeypatch, capsys):
    """--device cuda|cpu, default cuda, beside the JAX example's switch."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", "--help"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    assert done.value.code == 0
    usage = capsys.readouterr().out
    assert "--device {cuda,cpu}" in usage and "default: the card" in usage
    flags = {w.strip("[]") for w in usage.split() if w.startswith(("--",
                                                                    "[--"))}
    assert flags - {"--help", "--device"} == ({switch} if switch else set())
