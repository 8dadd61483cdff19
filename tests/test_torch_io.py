"""The corpus command's plumbing in voxtpu_torch against voxtpu on the CPU:
`formants.resample_sinc`, the packed single-buffer fetch of the corpus
block (`_analyze_batch_padded_packed`, `_unpack_frames`,
`analyze_batch_padded_fetch`), and `profiling`.

resample_sinc is held to voxtpu's at rtol 1e-12 in float64 (the same tap
sums in the same order; sin and cos of two libraries differ in the last
ulp). The packed fetch is exact: it moves the same values into one buffer
and back, and float64 round-trips every int32 status and bool flag.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from voxtpu import pipeline as jp
from voxtpu.formants import resample_sinc as jax_resample_sinc

from voxtpu_torch import pipeline as tp
from voxtpu_torch import profiling
from voxtpu_torch.formants import resample_sinc
from voxtpu_torch.io_wav import read_wav

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ratio", [0.25, 11025.0 / 44100.0 * 1.5, 1.0, 2.0])
def test_resample_sinc_matches_voxtpu(ratio):
    x = read_wav(os.path.join(FIX, "short_sample.wav")).samples
    out_len = int(np.floor((len(x) - 1) * ratio)) + 1
    want = np.asarray(jax_resample_sinc(jnp.asarray(x), ratio, out_len))
    got = resample_sinc(torch.as_tensor(x), ratio, out_len)
    assert got.dtype == torch.float64 and got.shape == (out_len,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def test_resample_sinc_chunking_changes_nothing():
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(3000))
    whole = resample_sinc(x, 0.7, 2100, chunk=1 << 20)
    assert torch.equal(resample_sinc(x, 0.7, 2100, chunk=333), whole)
    with pytest.raises(ValueError, match="1-D"):
        resample_sinc(x[None], 0.7, 10)


SR = 11025.0
JCFG = jp.AnalysisConfig(
    sample_rate=SR, frame_len=512, hop=256,
    pitch=jp.PitchConfig(fmin=60.0, fmax=500.0, max_candidates=16),
    formant=jp.FormantConfig(n_coeffs=10),
)
LENGTHS = [6000, 4100, 400]  # the last one is shorter than a frame


def _block(dtype=np.float64):
    x = read_wav(os.path.join(FIX, "down_sampled.wav")).samples
    S = np.zeros((3, 6100), dtype)
    for b, n in enumerate(LENGTHS):
        S[b, :n] = x[1000 * b : 1000 * b + n]
    return S


def _variants():
    cfg = tp.config_from_jax(JCFG)
    off = lambda c: dataclasses.replace(c, enabled=False)  # noqa: E731
    return {
        "all": cfg,
        "viterbi": dataclasses.replace(cfg, pitch=dataclasses.replace(cfg.pitch, viterbi=True)),
        "no_pitch": dataclasses.replace(cfg, pitch=off(cfg.pitch)),
        "no_formants_no_mfcc": dataclasses.replace(cfg, formant=off(cfg.formant), mfcc=off(cfg.mfcc)),
    }


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(_variants()))
def test_packed_fetch_round_trips_exactly(name, dtype):
    """Every feature of every variant comes back with its key, shape, dtype
    and values: the manifest the packed buffer carries is what
    `analyze_batch_padded` returned."""
    cfg = _variants()[name]
    block = _block(dtype)
    want = {k: v.numpy() for k, v in tp.analyze_batch_padded(block, LENGTHS, cfg, device="cpu").items()}
    flat, manifest = tp._analyze_batch_padded_packed(block, LENGTHS, cfg, device="cpu")
    assert flat.dtype == torch.from_numpy(block).dtype and flat.shape[:2] == (3, want["rms"].shape[1])
    assert [k for k, _, _ in manifest] == sorted(want)
    got = tp._unpack_frames(flat.numpy(), manifest)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    trimmed = tp.analyze_batch_padded_fetch(block, LENGTHS, cfg, trim_to=10, device="cpu")
    for k in want:
        np.testing.assert_array_equal(trimmed[k], want[k][:, :10], err_msg=k)


def test_packed_fetch_matches_voxtpu():
    """The port's `analyze_batch_padded_fetch` against voxtpu's, float64, at
    tests/test_torch_batch.py's tolerances (weak noise-floor candidate
    lanes of near-silent frames left out, PARITY deviation 7)."""
    from test_torch_batch import _check

    block = _block()
    want = jp.analyze_batch_padded_fetch(block, np.asarray(LENGTHS, np.int32), JCFG, trim_to=20)
    got = tp.analyze_batch_padded_fetch(block, LENGTHS, tp.config_from_jax(JCFG), trim_to=20, device="cpu")
    assert got.keys() == want.keys()
    flat = lambda d: {k: v.reshape((-1,) + v.shape[2:]) for k, v in d.items()}  # noqa: E731
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        _check(k, flat(got), flat(want))


def test_stage_report_times_five_subsets():
    frames = torch.as_tensor(_block()[0, :4096].reshape(8, 512))
    report = profiling.stage_report(frames, tp.config_from_jax(JCFG), iters=1)
    assert sorted(report) == ["formants", "full", "mfcc", "pitch", "rms"]
    assert all(isinstance(v, float) and v > 0 for v in report.values())


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert profiling.timed(lambda: torch.ones(3).sum(), iters=2) > 0
