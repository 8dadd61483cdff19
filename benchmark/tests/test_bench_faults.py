"""The check against a broken timed path: a run on the CPU at a tiny size,
its look for a card skipped, with the corpus entry broken underneath, must
come out not correct, once for each fault the cells can have: half of a
block's recordings left out, an answer altered where it is produced (an
MFCC after the entry; kernel A's refined lags inside it), and the
tracker's state left unchanged from frame to frame. (No cell spans chips,
so none can lose an exchange between them.)"""

import numpy as np
import pytest
import torch

import voxtpu_torch.pipeline as pipeline
import voxtpu_torch.sinc as sinc
from benchmark import run as R
from benchmark.harness import cell
from benchmark.tests.conftest import run_args

ENTRY = pipeline.analyze_batch_padded_fetch
REFINE = sinc.refine


def half_left_out(x, lengths, config, trim_to=None, device=None):
    """Only the first half of the block's rows analysed; the rest zero."""
    keep = max(1, x.shape[0] // 2)
    out = ENTRY(x[:keep], lengths[:keep], config, trim_to=trim_to, device=device)
    return {k: np.concatenate([v, np.zeros((x.shape[0] - keep,) + v.shape[1:], v.dtype)]) for k, v in out.items()}


def answer_altered(x, lengths, config, trim_to=None, device=None):
    """One MFCC of the first recording's first frame (a frame the check
    always compares) off by 0.01."""
    out = ENTRY(x, lengths, config, trim_to=trim_to, device=device)
    out["mfcc"][0, 0, 3] += 0.01
    return out


def state_unchanged(x, lengths, config, trim_to=None, device=None):
    """The formant tracker's carry never stepped: every frame holds the seed."""
    out = ENTRY(x, lengths, config, trim_to=trim_to, device=device)
    seed = np.asarray(config.formant.estimates, out["formant_freqs"].dtype)
    out["formant_freqs"][...] = seed
    out["formant_bws"][...] = config.formant.estimate_bandwidth
    return out


def lag_off_by_one(x, lengths, config, trim_to=None, device=None):
    """Kernel A's refined lags one sample long, as an index off by one in
    its lag buffer would give; its strengths as they were."""

    def refine(*args, **kw):
        x, fx = REFINE(*args, **kw)
        return x + 1.0, fx

    sinc.refine = refine
    try:
        return ENTRY(x, lengths, config, trim_to=trim_to, device=device)
    finally:
        sinc.refine = REFINE


@pytest.mark.parametrize("workload", ["cli.short", "viterbi.short"])
@pytest.mark.parametrize("fault", [half_left_out, answer_altered, lag_off_by_one, state_unchanged],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, workload, fault):
    monkeypatch.setattr(pipeline, "analyze_batch_padded_fetch", fault)
    res = R.run(run_args(workload), cell.load(workload, tiny_root), torch.device("cpu"),
                root=tiny_root, pinned=False)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())
