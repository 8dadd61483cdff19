"""Each per-layer metric's reader on a synthetic trace, and the arithmetic
of the trace (busy time, idle gaps, their host spans)."""

import pytest

from benchmark.harness import bounds, cell, trace
from benchmark.run import reader
from benchmark.tests.conftest import ROOT

CFG = cell.load_json(ROOT / "benchmark" / "configs" / "cli_viterbi_44k.json")
NAMES = trace.kernel_names(ROOT / "benchmark" / "port_kernels.txt")


class _Blk:
    def __init__(self, frames):
        self.frames = frames


def _trace(acts, window=(0.0, 1.0), spans=(), blocks=2, syncs=4, config=CFG):
    return trace.Trace([trace.Activity(*a) for a in acts], window, list(spans),
                       [_Blk([100, 50]) for _ in range(blocks)], syncs, blocks, config, NAMES)


ACTS = [
    ("Memcpy HtoD (Pinned -> Device)", 0.00, 0.01),
    ("void burg_kernel<float, 4>(float const*, float*, int*, int, int)", 0.02, 0.05),
    ("viterbi_chain", 0.05, 0.06),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", 0.055, 0.08),
    ("Memset (Device)", 0.09, 0.095),
    ("Memcpy DtoH (Device -> Pinned)", 0.40, 0.45),
]


def test_every_benchmark_metric_has_a_reader():
    spec = cell.load_json(ROOT / "BENCHMARK.json")
    for m in spec["per_layer"]:
        assert callable(reader(m["name"]))


def test_busy_and_idle():
    t = _trace(ACTS)
    assert t.busy_s() == pytest.approx(0.01 + 0.06 + 0.005 + 0.05)
    assert reader("device_idle_share")(t) == pytest.approx(1 - t.busy_s())


def test_time_per_block_by_kind():
    t = _trace(ACTS)
    assert reader("memcpy_ms_per_block")(t) == pytest.approx((0.01 + 0.05) * 1e3 / 2)
    assert reader("port_kernels_ms_per_block")(t) == pytest.approx((0.03 + 0.01) * 1e3 / 2)
    assert reader("torch_ops_ms_per_block")(t) == pytest.approx(0.025 * 1e3 / 2)
    assert reader("host_syncs_per_block")(t) == pytest.approx(2.0)


def test_rooflines_count_real_frames_over_the_kernel_time():
    t = _trace(ACTS)
    frames = 2 * 150
    least, _ = bounds.burg_bound(frames, CFG["frame_len"], CFG["formant"]["n_coeffs"])
    assert reader("burg_roofline")(t) == pytest.approx(100 * least / 0.03)
    least, _ = bounds.viterbi_bound(frames, CFG["pitch"]["max_candidates"] + 1)
    assert reader("viterbi_roofline")(t) == pytest.approx(100 * least / 0.01)


def test_readers_return_nothing_without_their_kernel():
    t = _trace([("Memcpy HtoD (Pinned -> Device)", 0.0, 0.1)])
    for name in ("burg_roofline", "viterbi_roofline", "port_kernels_ms_per_block"):
        assert reader(name)(t) is None
    no_path = dict(CFG, pitch=dict(CFG["pitch"], viterbi=False))
    assert reader("viterbi_roofline")(_trace(ACTS, config=no_path)) is None


def test_kernel_names_match_whole_words_only():
    assert trace.kernel_of("void refine_kernel<double>(double const*)", NAMES) == "refine_kernel"
    assert trace.kernel_of("burg_kernel_probe", NAMES) is None
    assert trace.kernel_of("void at::native::reduce_kernel<512, 1>", NAMES) is None


def test_breakdown_names_gaps_by_the_open_span():
    spans = [("entry", 0.0, 0.3), ("fetch", 0.3, 0.5), ("copy_in", 0.5, 1.0)]
    b = trace.breakdown(_trace(ACTS, spans=spans))
    assert b["device_ops"][0][0].startswith("Memcpy DtoH")
    gaps = b["idle_gaps"]
    assert gaps[0] == ["fetch", pytest.approx(0.55)]
    assert gaps[1] == ["entry", pytest.approx(0.305)]
    assert len(b["device_ops"]) <= 10 and len(gaps) <= 10
