"""The benchmark's tests: the checkout's root on the path, and the card
looked for inside a fixture, never at import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA card the `chip` tests run on; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


TINY_MIX = {"recordings_per_block": 2, "blocks": 2, "seconds_min": 0.3, "seconds_max": 0.6,
            "check_blocks": 1, "check_frames": 64, "trace_blocks": 2}


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout root whose BENCHMARK.json and configurations are the
    benchmark's own and whose traffic mixes are cut to two blocks of two
    recordings of 0.3-0.6 s, so that a run fits on the CPU."""
    import json
    import shutil

    bench = tmp_path / "benchmark"
    bench.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name in ("configs", "metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / name, bench / name)
    shutil.copy(ROOT / "benchmark" / "port_kernels.txt", bench / "port_kernels.txt")
    (bench / "traffic").mkdir()
    for mix in (ROOT / "benchmark" / "traffic").glob("*.json"):
        spec = json.loads(mix.read_text())
        spec.update(TINY_MIX)
        (bench / "traffic" / mix.name).write_text(json.dumps(spec))
    return tmp_path


def run_args(workload: str, seed: int = 2**31 + 7, seconds: float = 5.0, trace: int = 0):
    from benchmark.run import parse

    return parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])
