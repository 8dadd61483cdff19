"""A cell, found by name: its `BENCHMARK.json` entry, its configuration file
(`benchmark/configs/<config>.json`), its traffic mix
(`benchmark/traffic/<mix>.json`) and its check's limits
(`benchmark/limits/<cell>.json`). Nothing here knows any one cell."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether `metric` is reported in `cell`: every cell, or those listed."""
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json. Raises KeyError for a name
    the file does not list."""
    spec = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        mix=load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "benchmark" / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if reports(m, name)],
    )


def port_config(cfg: dict):
    """The port's `AnalysisConfig` for a configuration file."""
    from voxtpu_torch.pipeline import AnalysisConfig, FormantConfig, MfccConfig, PitchConfig

    p, f, m = cfg["pitch"], cfg["formant"], cfg["mfcc"]
    return AnalysisConfig(
        sample_rate=float(cfg["sample_rate"]), frame_len=int(cfg["frame_len"]), hop=int(cfg["hop"]),
        pitch=PitchConfig(enabled=True, threshold=p["threshold"], fmin=p["fmin"], fmax=p["fmax"],
                          max_candidates=p["max_candidates"], viterbi=p["viterbi"], refine=p["refine"],
                          refine_depth=p["refine_depth"]),
        formant=FormantConfig(enabled=True, n_coeffs=f["n_coeffs"], estimates=tuple(f["estimates"]),
                              estimate_bandwidth=f["estimate_bandwidth"], polish=f["polish"]),
        mfcc=MfccConfig(enabled=True, num_coeffs=m["num_coeffs"], freq_lo=m["freq_lo"], freq_hi=m["freq_hi"]),
    )
