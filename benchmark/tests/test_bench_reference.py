"""The plain reference against the port's own CPU path (its plain
versions) at a tiny size, float64: the same answers on every key, both
configurations; and the two ways its tracker runs agree."""

import numpy as np
import pytest
import torch

from benchmark.harness import cell, traffic
from benchmark.reference import analysis, serial
from benchmark.tests.conftest import ROOT

MIX = {"recordings_per_block": 3, "blocks": 1, "seconds_min": 0.4, "seconds_max": 0.9, "gain_min": 0.5,
       "gain_max": 2.0, "bucket_frames": 1024, "trim_step": 64}
KEYS = ("f0", "f0_strength", "hnr_db", "pitch_candidates_freq", "pitch_candidates_strength",
        "pitch_candidates_valid", "formant_freqs", "formant_bws", "mfcc", "rms", "status")


@pytest.mark.parametrize("config", ["cli_default_44k", "cli_viterbi_44k"])
def test_reference_equals_the_port_cpu_path(config):
    from voxtpu_torch.pipeline import analyze_batch_padded

    cfg = cell.load_json(ROOT / "benchmark" / "configs" / f"{config}.json")
    blk = traffic.make_pool(MIX, cfg, 2**32 + 1)[0]
    port = analyze_batch_padded(torch.as_tensor(blk.samples, dtype=torch.float64), torch.as_tensor(blk.lengths),
                                cell.port_config(cfg))
    ref = analysis.analyze_block(blk.samples, blk.lengths, blk.padded_frames, cfg, torch.float64, "cpu")
    assert len(ref) == 3
    for b, (r, nf) in enumerate(zip(ref, blk.frames)):
        for k in KEYS:
            got = port[k][b, :nf].numpy()
            assert got.shape == r[k].shape, k
            np.testing.assert_allclose(got, r[k], rtol=1e-9, atol=1e-9, err_msg=k)


def test_tracker_from_the_previous_frame_equals_serial():
    g = torch.Generator().manual_seed(3)
    F = 400
    rf = torch.sort(torch.rand(F, 14, generator=g, dtype=torch.float64) * 5000, dim=1).values
    rf = torch.nn.functional.pad(torch.where(torch.rand(F, 14, generator=g) < 0.2, 0.0, rf), (0, 18))
    rb = torch.rand(F, 32, generator=g, dtype=torch.float64) * 300
    est = torch.tensor([320.0, 1440.0, 2760.0, 3200.0], dtype=torch.float64)
    sf, sb = serial.track_serial(rf.numpy(), rb.numpy(), est.numpy(), np.ones(4))
    ff, fb = serial.track_from(rf, rb, est, torch.ones(4, dtype=torch.float64), torch.as_tensor(sf),
                               torch.as_tensor(sb), torch.arange(F))
    np.testing.assert_array_equal(ff.numpy(), sf)
    np.testing.assert_array_equal(fb.numpy(), sb)


def test_tf32_rounds_to_ten_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0e-5, float("inf")], dtype=torch.float32)
    y = analysis.tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2**-9 and y[3] == float("inf")
    mant = y[:3].view(torch.int32) & 0x1FFF
    assert not mant.any()
