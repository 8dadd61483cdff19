"""The traffic generator: pools from the seed, and the corpus block's ladder."""

import numpy as np
import pytest

from benchmark.harness import cell, traffic
from benchmark.tests.conftest import ROOT


def _mix(name):
    return cell.load_json(ROOT / "benchmark" / "traffic" / f"{name}.json")


CFG = cell.load_json(ROOT / "benchmark" / "configs" / "cli_default_44k.json")
SMALL = {"recordings_per_block": 3, "blocks": 2, "seconds_min": 0.5, "seconds_max": 2.0, "gain_min": 0.5,
         "gain_max": 2.0, "bucket_frames": 1024, "trim_step": 64}


def test_same_seed_same_pool():
    a = traffic.make_pool(SMALL, CFG, 2**31 + 5)
    b = traffic.make_pool(SMALL, CFG, 2**31 + 5)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x.samples, y.samples)
        np.testing.assert_array_equal(x.lengths, y.lengths)


def test_seeds_share_lengths_and_shapes_but_not_samples():
    a = traffic.make_pool(SMALL, CFG, 1)
    b = traffic.make_pool(SMALL, CFG, 2**40 + 3)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x.lengths, y.lengths)
        assert x.samples.shape == y.samples.shape and x.trim == y.trim and x.frames == y.frames
    assert any(not np.array_equal(x.samples, y.samples) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["long4", "long1", "short64"])
def test_mix_lengths_are_fixed_quantiles(name):
    mix = _mix(name)
    s = traffic.lengths_s(mix)
    assert s.shape == (mix["recordings_per_block"] * mix["blocks"],)
    assert mix["seconds_min"] < s.min() and s.max() < mix["seconds_max"] and np.all(np.diff(s) > 0)


def test_short64_lands_on_the_issue_rungs():
    mix = _mix("short64")
    n, hop = CFG["frame_len"], CFG["hop"]
    lens = np.round(traffic.lengths_s(mix) * CFG["sample_rate"]).astype(int)
    R = mix["recordings_per_block"]
    rungs = {traffic.bucket_target_fine(max(traffic.num_frames(int(x), n, hop) for x in lens[b:b + R]), 1024)
             for b in range(0, len(lens), R)}
    assert rungs == {192, 256, 384, 512}


def test_ladder_matches_the_corpus_command():
    from voxtpu_torch.cli import _bucket_target_fine

    for F in list(range(1, 3000)) + [4095, 4096, 4097, 36000, 36864, 36865]:
        assert traffic.bucket_target_fine(F, 1024) == _bucket_target_fine(F, 1024)


def test_recording_is_the_fixture_tiled_and_scaled():
    one, _sr = traffic.read_fixture()
    seed = 2**33 + 9
    pool = traffic.make_pool(SMALL, CFG, seed)
    rng = traffic.rng_for(seed, 0)
    n = SMALL["recordings_per_block"] * SMALL["blocks"]
    offsets = rng.integers(0, one.shape[0], n)
    gains = rng.uniform(SMALL["gain_min"], SMALL["gain_max"], n).astype(np.float32)
    R = SMALL["recordings_per_block"]
    for k in range(n):
        blk = pool[k // R]
        L = blk.lengths[k % R]
        want = np.tile(np.roll(one, -offsets[k]), L // one.shape[0] + 1)[:L] * gains[k]
        np.testing.assert_array_equal(blk.samples[k % R, :L], want)
        assert not blk.samples[k % R, L:].any()


def test_visits_cover_the_pool_each_pass():
    import itertools

    v = list(itertools.islice(traffic.visits(5, 77), 15))
    for p in range(3):
        assert sorted(v[5 * p : 5 * p + 5]) == list(range(5))
