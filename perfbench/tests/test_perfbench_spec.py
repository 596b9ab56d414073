"""BENCHMARK.json against the benchmark's rules, and the harness's files
against it: names, units, keys, the metric graph, one file per
configuration, traffic mix, limit set and metric, and no import of JAX or
the JAX package anywhere under perfbench/."""

import ast
import json
import os
import re

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "xrsfm_tpu"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32
    for word in cmd:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word
        if os.path.exists(os.path.join(ROOT, word)):
            assert any(word == p or word.startswith(p.rstrip("/") + "/")
                       for p in bench["paths"])


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_names_and_units(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _one_line(c["source"])
        assert _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p.rstrip("/") + "/"
                                          for p in bench["paths"]))
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for m in bench[group]:
            assert m["name"] not in names, m["name"]
            names.add(m["name"])
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_metrics_graph(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells

    def reports(metric, cell):
        return cell in e2e[metric].get("workloads", cells)

    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _one_line(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(m["moves"], cell), \
                (m["name"], cell)
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in cells:
        assert reports("setup_s", cell)
        assert any(reports(n, cell) for n in e2e if n != "setup_s")
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])


def test_every_name_has_its_file(bench):
    for w in bench["workloads"]:
        t = os.path.join(PKG, "traffic", w["traffic"] + ".json")
        assert os.path.isfile(t), t
        with open(t) as f:
            drv = json.load(f)["driver"]
        assert os.path.isfile(os.path.join(PKG, "drivers", drv + ".py"))
        lim = os.path.join(PKG, "limits", w["name"] + ".json")
        with open(lim) as f:
            numbers = json.load(f)["numbers"]
        for name, n in numbers.items():
            if n.get("exact"):  # a count compared exactly
                assert n["lower"] == n["limit"] == 0, name
            else:
                assert n["lower"] < n["limit"] < n["upper"], name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(PKG, "metrics", m["name"] + ".py"))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_import():
    found = []
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                for mod in _imports(p):
                    if mod.split(".")[0] in FORBIDDEN:
                        found.append((p, mod))
    assert not found


def test_forbidden_names_compare_whole():
    from perfbench.lib import harness

    assert "xrsfm_tpu_torch" not in harness.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "xrsfm_tpu"} == set(harness.FORBIDDEN)


def _code_strings(path):
    """String constants of a module that are not docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)
            and isinstance(n.value, ast.Constant)}
    return [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_reads_nothing_of_the_old_benchmarks():
    """No path to bench.py, scripts/ or the JAX era's BENCH / MULTICHIP /
    BASELINE files appears in the harness's code."""
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if f.endswith(".py") and d != HERE:
                for text in _code_strings(os.path.join(d, f)):
                    for old in ("BENCH_r0", "MULTICHIP_r0", "BASELINE",
                                "bench.py", "scripts/", "scripts"):
                        assert old not in text, (f, text)
