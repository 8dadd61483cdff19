"""voxtpu_torch.bench on the CPU at a small size, and `python -m
voxtpu_torch bench` reaching it.

The CPU numbers here are no device metric: the test checks the keys, that
every value is finite and positive, and the workload's arithmetic
(frames and audio seconds). chip_smoke.py's phase 13 runs the benchmark
on the card at full size.
"""

import json
import math
import re
from pathlib import Path

import pytest
import torch

from voxtpu_torch import bench, cli
from voxtpu_torch.frame import num_frames
from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.pipeline import BENCH_44K

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_keys_are_bench_pys():
    """The JSON line's keys are those of bench.py's result (bench.py:146-155)."""
    src = (ROOT / "bench.py").read_text()
    block = src[src.index("result = {"): src.index("}", src.index("result = {"))]
    assert tuple(re.findall(r'"(\w+)":', block)) == bench.KEYS


def test_run_small_on_cpu():
    got = bench.run(device="cpu", tiles=1, iters=1, chain=2)
    assert set(bench.KEYS) <= set(got)
    for key in ("value", "vs_baseline", "wall_ms", "device_ms", "sustained_xrt", "tunnel_floor_ms"):
        assert math.isfinite(got[key]) and got[key] > 0, (key, got[key])
    samples = len(read_wav(str(bench.FIXTURE)).samples)
    assert got["frames"] == num_frames(samples, BENCH_44K.frame_len, BENCH_44K.hop) > 0
    assert got["audio_seconds"] == got["frames"] * BENCH_44K.hop / BENCH_44K.sample_rate
    assert got["value"] == pytest.approx(got["audio_seconds"] / (got["wall_ms"] / 1e3))
    assert got["vs_baseline"] == pytest.approx(got["value"] / bench.BASELINE_XRT)
    assert got["host_syncs"] == 0 and got["host_sync_sites"] == [] and got["device"] == "cpu"
    assert got["metric"] == "pitch+formant+mfcc throughput"


def test_cli_bench_reaches_the_module(monkeypatch, capsys):
    """`bench --device cpu` runs voxtpu_torch.bench on the CPU (its heavy
    function stubbed) and prints one JSON line of bench.py's keys, exit 0."""
    seen = {}

    def fake_run(device=None, **kw):
        seen["device"] = device
        return {**{k: 1.0 for k in bench.KEYS}, "frames": 1, "audio_seconds": 1.0, "host_syncs": 0,
                "host_sync_sites": [], "device": "cpu"}

    monkeypatch.setattr(bench, "run", fake_run)
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and tuple(json.loads(lines[0])) == bench.KEYS
    assert seen["device"] == torch.device("cpu")


def test_missing_fixture_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(bench, "FIXTURE", tmp_path / "absent.wav")
    with pytest.raises(FileNotFoundError, match="bench fixture"):
        bench.run(device="cpu", tiles=1, iters=1, chain=2)
