"""The benchmark's files against its contract: every name resolves to its
files, names and units keep to their characters, each per-layer metric's
cells report the end-to-end metric it moves, and nothing under perfbench/
imports JAX, the JAX package or the old benchmarks."""
import ast
import json
import re

import pb_tiny

SPEC = pb_tiny.spec()
PB, ROOT = pb_tiny.PB, pb_tiny.ROOT
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|experts_per_tok)")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = 24  # what every later check must still fit
    need = ((2 + 14 * cells) * (SPEC["run_seconds"] + 60)
            + cells * 2 * 90 + 1200)
    assert need <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    assert len(set(c["name"] for c in SPEC["configs"])) == len(SPEC["configs"])
    assert len(set(w["name"] for w in SPEC["workloads"])) == \
        len(SPEC["workloads"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
    for c in SPEC["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])


def test_entries_have_exactly_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}


def test_every_name_resolves_to_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (PB / "systems" / f"{cfg['system']}.py").is_file()
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    used = set()
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((PB / "limits" / f"{w['name']}.json")
                            .read_text())["limits"]
        assert all(v >= 0 for v in limits.values())
    assert used == set(configs)
    for m in SPEC["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file()


def test_each_cell_reports_setup_an_end_to_end_and_a_layer_metric():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in cells:
        mine = {m["name"] for m in SPEC["end_to_end"]
                if w in m.get("workloads", cells)}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w in m.get("workloads", cells)
                   for m in SPEC["per_layer"])


def test_each_layer_metric_moves_what_its_cells_report():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in moved.get("workloads", cells), (m["name"], w)
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer
    shares = [m for m in SPEC["per_layer"]
              if m["name"].endswith("_roofline") or "mfu" in m["name"]]
    assert shares and all(m["unit"] == "%" for m in shares)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _strings(path):
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def test_no_jax_no_jax_package_no_old_benchmarks():
    for path in PB.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        assert "benchmarks" not in tops, path
        if path.parent.name != "tests":  # no path into benchmarks/
            assert not any(s == "benchmarks" or "benchmarks/" in s
                           for s in _strings(path) if len(s) < 200), path
    for path in (PB / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "repro_torch" not in tops, path
        assert "repro_torch" not in path.read_text(), path
