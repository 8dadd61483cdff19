"""A run end to end on the CPU at a tiny size: the result's keys, the refusal
without a card, and a cell, a mix and a metric added from new files only."""

import ast
import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run as R
from benchmark.harness import cell
from benchmark.tests.conftest import ROOT, run_args

BENCH = ROOT / "benchmark"


def _run(root, workload, **kw):
    return R.run(run_args(workload, **kw), cell.load(workload, root), torch.device("cpu"), root=root, pinned=False)


def test_result_keys(tiny_root):
    res = _run(tiny_root, "cli.short")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if "cli.short" in m.get("workloads", ["cli.short"])}
    assert set(res["metrics"]) == want and {"audio_s_per_s", "setup_s"} <= want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    limits = json.loads((BENCH / "limits" / "cli.short.json").read_text())
    assert set(res["check"]) == set(limits)
    json.dumps(res)


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "cli.long", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_workload_is_refused(capsys):
    assert R.main(["--workload", "no.such", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_new_cell_mix_and_metric_from_new_files_alone(tiny_root):
    """Files that exist are neither edited nor needed by name: a new mix,
    a new cell's limits, a new metric's reader and the BENCHMARK.json
    entries that name them are enough."""
    before = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    b = tiny_root / "benchmark"
    mix = json.loads((b / "traffic" / "short64.json").read_text())
    mix["recordings_per_block"] = 3
    (b / "traffic" / "short3.json").write_text(json.dumps(mix))
    shutil.copy(b / "limits" / "cli.short.json", b / "limits" / "cli.short3.json")
    (b / "metrics" / "blocks_traced.py").write_text("def read(trace):\n    return float(len(trace.blocks))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "cli.short3", "config": "cli_default_44k", "traffic": "short3", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "blocks_traced", "unit": "blocks", "better": "higher",
                              "source": "program_counter", "layer": "entry", "moves": "audio_s_per_s",
                              "workloads": ["cli.short3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    c = cell.load("cli.short3", tiny_root)
    assert [m["name"] for m in c.per_layer][-1] == "blocks_traced"
    assert R.reader("blocks_traced", tiny_root)(type("T", (), {"blocks": [1, 2]})()) == 2.0
    res = _run(tiny_root, "cli.short3")
    assert res["correct"] is True
    after = {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_jax_anywhere_and_no_port_in_the_reference(path):
    names = _imports(BENCH / path)
    assert not names & {"jax", "jaxlib", "flax", "voxtpu"}, names
    if path.startswith("reference/"):
        assert "voxtpu_torch" not in names, names


def test_forbidden_modules_compares_whole_names():
    assert R.forbidden_modules(["voxtpu_torch", "voxtpu_torch.pipeline", "jaxtyping", "numpy"]) == []
    assert R.forbidden_modules(["voxtpu.pipeline", "jax._src.core", "flax", "torch"]) == ["flax", "jax", "voxtpu"]
