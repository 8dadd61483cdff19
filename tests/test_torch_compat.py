"""voxtpu_torch.compat, every shim against voxtpu.compat on the CPU.

Float64 throughout. Pitch lists and paths agree at
tests/test_torch_pitch.py's tolerance (rtol 1e-5 on frequency and
strength); the formant iterator is exact, as kernel D's plain version is
(tests/test_torch_formants.py).
"""

import numpy as np
import pytest
import torch

from voxtpu import compat as jcompat
from voxtpu.windows import hann

from util import sine_hz
from voxtpu_torch import compat
from voxtpu_torch.device import NoCudaDevice


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_work_size_helpers_match():
    for buf_len, n_coeffs in ((1024, 13), (2205, 10), (0, 0)):
        assert compat.find_formants_real_work_size(buf_len, n_coeffs) == \
            jcompat.find_formants_real_work_size(buf_len, n_coeffs) == buf_len * 2 + n_coeffs * 23 + 2
        assert compat.find_formants_complex_work_size(n_coeffs) == jcompat.find_formants_complex_work_size(n_coeffs)


def _resonance_frames(mod):
    return [
        [mod.Resonance(f, 1.0) for f in fr]
        for fr in (
            [100.0, 150.0, 200.0, 240.0, 300.0],
            [110.0, 180.0, 210.0, 230.0, 310.0],
            [230.0, 270.0, 290.0, 350.0, 360.0],
        )
    ]


def test_formant_extractor_golden_and_equal_to_voxtpu():
    """spectrum.rs:528-567 through the iterator (tests/test_compat.py:18-33)."""
    est = [compat.Resonance(f, 1.0) for f in (140.0, 230.0, 320.0)]
    got = [[(r.frequency, r.bandwidth) for r in frame]
           for frame in compat.FormantExtractor(3, _resonance_frames(compat), est, device="cpu")]
    assert [[f for f, _ in frame] for frame in got] == [[150.0, 240.0, 300.0], [180.0, 230.0, 310.0],
                                                      [230.0, 270.0, 290.0]]
    jest = [jcompat.Resonance(f, 1.0) for f in (140.0, 230.0, 320.0)]
    want = [[(r.frequency, r.bandwidth) for r in frame]
            for frame in jcompat.FormantExtractor(3, _resonance_frames(jcompat), jest)]
    assert got == want


def test_formant_extractor_random_tracks_equal_voxtpu():
    rng = np.random.default_rng(8)
    frames = [sorted(rng.uniform(100, 4000, rng.integers(2, 9)).round(-1)) for _ in range(40)]
    bws = rng.uniform(20, 300, (40, 9)).round()
    res_t = [[compat.Resonance(f, bws[i, j]) for j, f in enumerate(fr)] for i, fr in enumerate(frames)]
    res_j = [[jcompat.Resonance(f, bws[i, j]) for j, f in enumerate(fr)] for i, fr in enumerate(frames)]
    est = (320.0, 1440.0, 2760.0, 3200.0)
    got = [[(r.frequency, r.bandwidth) for r in fr]
           for fr in compat.FormantExtractor(4, res_t, [compat.Resonance(e, 1.0) for e in est], device="cpu")]
    want = [[(r.frequency, r.bandwidth) for r in fr]
            for fr in jcompat.FormantExtractor(4, res_j, [jcompat.Resonance(e, 1.0) for e in est])]
    assert got == want


def test_empty_extractors():
    assert list(compat.FormantExtractor(4, [], [], device="cpu")) == []
    assert list(compat.PitchExtractor([], device="cpu")) == []


def _candidates(mod):
    rng = np.random.default_rng(4)
    frames = []
    for t in range(30):
        f0 = 120.0 + 10.0 * np.sin(t / 4)
        frames.append([mod.Pitch(f0, 0.6 + 0.3 * rng.random()), mod.Pitch(2 * f0, 0.5 * rng.random()),
                       mod.Pitch(0.0, 0.45)][: 1 + t % 3])
    return frames


@pytest.mark.parametrize("use_path", [False, True])
def test_pitch_extractor_matches_voxtpu(use_path):
    got = [(p.frequency, p.strength) for p in compat.PitchExtractor(_candidates(compat), use_path=use_path,
                                                                      device="cpu")]
    want = [(p.frequency, p.strength) for p in jcompat.PitchExtractor(_candidates(jcompat), use_path=use_path)]
    assert len(got) == len(want) == 30
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-12)


def test_pitch_six_arg_matches_voxtpu():
    x = sine_hz(150.0, 44100.0, 2048) * np.asarray(hann(2048))
    got = compat.pitch(x, 44100.0, 0.2, 1.0, 1.0, 100.0, 500.0, device="cpu")
    want = jcompat.pitch(x, 44100.0, 0.2, 1.0, 1.0, 100.0, 500.0)
    assert len(got) == len(want) and abs(got[0].frequency - 150.0) < 1e-2
    np.testing.assert_allclose([(p.frequency, p.strength) for p in got],
                               [(p.frequency, p.strength) for p in want], rtol=1e-5)


@pytest.mark.parametrize("with_intensity", [False, True])
def test_pitch_praat_matches_voxtpu(with_intensity):
    sr, n, hop, F = 11025.0, 512, 256, 6
    x = sine_hz(220.0, sr, (F - 1) * hop + n) * np.linspace(1.0, 0.01, (F - 1) * hop + n)
    frames = np.stack([x[i * hop : i * hop + n] for i in range(F)]) * np.asarray(hann(n))
    li = np.abs(frames).max(-1) / np.abs(frames).max() if with_intensity else None
    f0, s0 = compat.pitch_praat(frames, sr, fmin=100.0, fmax=500.0, local_intensity=li, device="cpu")
    jf0, js0 = jcompat.pitch_praat(frames, sr, fmin=100.0, fmax=500.0, local_intensity=li)
    assert f0.shape == (F,) and isinstance(f0, np.ndarray)
    np.testing.assert_allclose(f0, jf0, rtol=1e-5)
    np.testing.assert_allclose(s0, js0, rtol=1e-5)
    np.testing.assert_allclose(f0[f0 > 0], 220.0, rtol=5e-3)


def test_shims_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the shim would run there")
    with pytest.raises(NoCudaDevice):
        compat.pitch(np.zeros(512), 11025.0, 0.2, 1.0, 1.0, 100.0, 500.0)
    with pytest.raises(NoCudaDevice):
        compat.PitchExtractor(_candidates(compat), use_path=True)
