"""`voxtpu_torch.dist` (sharded analysis over a (files, frames) mesh) on
the CPU, against voxtpu.

PyTorch has no virtual devices, so each mesh lists the CPU once a grid
cell (`["cpu"] * k`). Inputs are float64 from numpy seeds or the bundled
WAV; configurations are voxtpu's, carried over by `config_from_jax`.

- Exact mode against `voxtpu.pipeline.analyze_frames`, the serial path, per
  file: formant freqs and bandwidths, MFCC and RMS at rtol 1e-9, status
  exact. f0 and f0_strength at tests/test_torch_pipeline.py's tolerance
  (rtol 1e-5, 5e-3 on the integer-snap knife edge): the port's serial f0
  already parts from voxtpu's by up to 2.7e-8 relative on short_sample.wav
  (Brent's refine in another library), sharded or not. Every key is also
  held to the port's own serial `analyze_frames` at rtol 1e-9, so the
  sharding adds nothing. Shapes are voxtpu's own sharded tests'
  (tests/test_pipeline.py:104-189,360-380): short_sample.wav on 1x4 (10
  frames: the pad path), two files a files row at 2x4, Viterbi on 1x8 over
  12 frames, a 2x2 mesh.
- Halo mode against a composition of voxtpu's functions on every frame at
  rtol 1e-9: `analyze_frames(..., return_formant_candidates=True)` on the
  whole recordings, then `formant_tracker_batched` over [zeros or the left
  block's tail | block] (the body of voxtpu/dist.py:174-193), without a
  multi-device JAX process.
- The dryruns: `dryrun_multichip` at 4 and 8 listed devices (the real
  multi-process cluster is tests/test_torch_dist_cluster.py's).
- The devices rule: defaults take distinct cards and never repeat one.
  (tests/test_torch_basics.py checks in a subprocess that `dist` and
  `_dist_worker` import neither JAX nor voxtpu.)
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu import formants as jf
from voxtpu import pipeline as jp
from voxtpu.frame import frame_signal as jframe
from voxtpu.io_wav import read_wav

from voxtpu_torch import dist
from voxtpu_torch.device import NoCudaDevice
from voxtpu_torch.pipeline import analyze_frames, config_from_jax

from test_torch_pipeline import _assert_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV = os.path.join(ROOT, "tests", "fixtures", "short_sample.wav")
SR = 11025.0
# voxtpu's sharded tests' configuration (tests/test_pipeline.py:43-51).
JCFG = jp.AnalysisConfig(
    sample_rate=SR, frame_len=512, hop=256,
    pitch=jp.PitchConfig(fmin=100.0, fmax=500.0, max_candidates=16),
    formant=jp.FormantConfig(n_coeffs=10),
    mfcc=jp.MfccConfig(num_coeffs=13, freq_hi=5000.0),
)
JCFG_VITERBI = dataclasses.replace(JCFG, pitch=dataclasses.replace(JCFG.pitch, viterbi=True))
EXACT_KEYS = ("formant_freqs", "formant_bws", "mfcc", "rms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpus(k):
    return ["cpu"] * k


def _voxtpu(frames, jcfg, **kw):
    return {k: np.asarray(v) for k, v in jp.analyze_frames(jnp.asarray(frames), jcfg, **kw).items()}


def _hold_to_voxtpu(got: dict, want: dict, where: str) -> None:
    for k in EXACT_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=f"{k} @ {where}")
    np.testing.assert_array_equal(got["status"], want["status"], err_msg=f"status @ {where}")
    for k in ("f0", "f0_strength"):
        _assert_key(k, got, want, SR)


def _hold_to_port_serial(got: dict, frames: np.ndarray, cfg, where: str) -> None:
    want = {k: v.numpy() for k, v in analyze_frames(torch.as_tensor(frames), cfg).items()}
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        if want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-12, err_msg=f"{k} @ {where}")
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} @ {where}")


def _sines(freqs, seed):
    """voxtpu's multi-file fixture (tests/test_pipeline.py:136-147), sines
    with a little noise, at short_sample.wav's 10 frames (voxtpu takes 8):
    one compiled voxtpu shape for every exact case, and the pad path on
    every mesh of 4 frame shards."""
    rng = np.random.default_rng(seed)
    t = np.arange(9 * 256 + 512) / SR
    sigs = [np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.shape) for f in freqs]
    return np.stack([np.asarray(jframe(jnp.asarray(s), 512, 256)) for s in sigs])


@pytest.fixture(scope="module")
def short_case():
    wav = read_wav(WAV)
    frames = np.asarray(jframe(jnp.asarray(wav.samples), 512, 256))
    assert frames.shape[0] % 4  # the pad path
    return frames, _voxtpu(frames, JCFG)


@pytest.fixture(scope="module")
def four_files():
    frames = _sines((150.0, 210.0, 280.0, 350.0), seed=11)
    return frames, [_voxtpu(f, JCFG) for f in frames]


def _out(frames, jcfg, mesh, **kw):
    return {k: v.numpy() for k, v in dist.sharded_analyze(torch.as_tensor(frames), config_from_jax(jcfg), mesh,
                                                            **kw).items()}


# ---------------------------------------------------------------- exact mode


def test_exact_short_sample_1x4_pads_and_matches(short_case):
    frames, want = short_case
    got = _out(frames[None], JCFG, dist.make_mesh(1, 4, cpus(4)))
    got = {k: v[0] for k, v in got.items()}
    assert got["f0"].shape == (frames.shape[0],)
    _hold_to_voxtpu(got, want, "1x4")
    _hold_to_port_serial(got, frames, config_from_jax(JCFG), "1x4")


def test_exact_two_files_a_row_2x4(four_files):
    """Two files a files row: each carry starts from the seed, none leaks
    from the file before it."""
    frames, wants = four_files
    got = _out(frames, JCFG, dist.make_mesh(2, 4, cpus(8)))
    for i, want in enumerate(wants):
        gi = {k: v[i] for k, v in got.items()}
        _hold_to_voxtpu(gi, want, f"2x4 file {i}")
        _hold_to_port_serial(gi, frames[i], config_from_jax(JCFG), f"2x4 file {i}")


def test_exact_2d_mesh_2x2():
    frames = _sines((170.0, 240.0), seed=3)
    got = _out(frames, JCFG, dist.make_mesh(2, 2, cpus(4)), overlap=4)
    for i in range(2):
        gi = {k: v[i] for k, v in got.items()}
        _hold_to_voxtpu(gi, _voxtpu(frames[i], JCFG), f"2x2 file {i}")


def test_exact_viterbi_1x8_over_12_frames():
    """The path search spans the whole recording: candidates gathered over
    8 shards (12 frames pad to 16), the intensity peak over the real ones."""
    rng = np.random.default_rng(7)
    t = np.arange(11 * 256 + 512) / SR
    x = np.sin(2 * np.pi * 180 * t)
    x[len(x) // 2 :] = 0.001 * rng.standard_normal(len(x) - len(x) // 2)
    frames = np.asarray(jframe(jnp.asarray(x), 512, 256))
    assert frames.shape[0] == 12
    got = {k: v[0] for k, v in _out(frames[None], JCFG_VITERBI, dist.make_mesh(1, 8, cpus(8))).items()}
    want = _voxtpu(frames, JCFG_VITERBI)
    # voxtpu's own test holds the path's keys here (tests/test_pipeline.py:
    # 183-188): on a pure sine the order-10 LPC is ill-conditioned, and the
    # port's serial formants, bandwidths and MFCC already part from
    # voxtpu's (by 0.26 Hz at 154 Hz, ulps amplified). RMS and status hold.
    for k in ("f0", "f0_strength", "hnr_db"):
        _assert_key(k, got, want, SR)
    np.testing.assert_allclose(got["rms"], want["rms"], rtol=1e-9)
    np.testing.assert_array_equal(got["status"], want["status"])
    _hold_to_port_serial(got, frames, config_from_jax(JCFG_VITERBI), "1x8 viterbi")
    assert np.all(np.abs(got["f0"][:3] - 180.0) < 2.0) and np.all(got["f0"][-3:] == 0.0), got["f0"]


# ---------------------------------------------------------------- halo mode


def _voxtpu_halo(frames, jcfg, nshards, overlap):
    """voxtpu/dist.py:174-193 composed from voxtpu's functions on one
    device: the resonances of every frame (`formants.formant_candidates`,
    the call `analyze_frames(..., return_formant_candidates=True)` makes),
    then each block's [zeros or left tail | own] resonances through
    `formant_tracker_batched`, halo outputs dropped."""
    files, F, n = frames.shape
    f = jcfg.formant
    cands = jax.jit(functools.partial(jf.formant_candidates, sample_rate=jcfg.sample_rate, n_coeffs=f.n_coeffs,
                                      resample_ratio=f.resample_ratio, polish=f.polish))
    rf, rb, _status = (np.asarray(v) for v in cands(jnp.asarray(frames.reshape(-1, n))))
    rf, rb = rf.reshape(files, F, -1), rb.reshape(files, F, -1)
    est_f = jnp.asarray(f.estimates, dtype=jnp.float64)
    est_b = jnp.full_like(est_f, f.estimate_bandwidth)
    track = jax.jit(jf.formant_tracker_batched)
    Fl = F // nshards
    outs_f, outs_b = [], []
    for j in range(nshards):
        own = slice(j * Fl, (j + 1) * Fl)
        if j:
            hf, hb = rf[:, j * Fl - overlap : j * Fl], rb[:, j * Fl - overlap : j * Fl]
        else:
            hf = hb = np.zeros_like(rf[:, :overlap])
        tf, tb = track(jnp.asarray(np.concatenate([hf, rf[:, own]], 1)),
                       jnp.asarray(np.concatenate([hb, rb[:, own]], 1)), est_f, est_b)
        outs_f.append(np.asarray(tf)[:, overlap:])
        outs_b.append(np.asarray(tb)[:, overlap:])
    return np.concatenate(outs_f, 1), np.concatenate(outs_b, 1)


@pytest.fixture(scope="module")
def halo_want(four_files):
    frames, _ = four_files
    return _voxtpu_halo(frames, JCFG, nshards=2, overlap=5)  # overlap 8 clamps to a block's 5 frames


@pytest.mark.parametrize("files_axis", [1, 2])
def test_halo_2_shards_matches_voxtpu_composition(four_files, halo_want, files_axis):
    """Halo mode (exact=False) on every frame, the first shard's zero halo
    included, at two files a row (files_axis 2) and four (files_axis 1)."""
    frames, _ = four_files
    got = _out(frames, JCFG, dist.make_mesh(files_axis, 2, cpus(2 * files_axis)), exact=False)
    want_f, want_b = halo_want
    np.testing.assert_allclose(got["formant_freqs"], want_f, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["formant_bws"], want_b, rtol=1e-9, atol=1e-12)


def test_halo_one_shard_is_the_exact_carry(four_files):
    """With one frame shard there is no halo: the carry is the serial one."""
    frames, wants = four_files
    got = _out(frames, JCFG, dist.make_mesh(2, 1, cpus(2)), exact=False)
    for i, want in enumerate(wants):
        np.testing.assert_allclose(got["formant_freqs"][i], want["formant_freqs"], rtol=1e-9)


# ---------------------------------------------------------------- dryruns


def test_dryrun_multichip_4(capsys):
    dist.dryrun_multichip(4, devices=cpus(4))
    out = capsys.readouterr().out
    assert out.count("dryrun topology ok") == 4 and "dryrun_multichip ok: 4 topologies" in out


def test_dryrun_multichip_8_subset(capsys):
    dist.dryrun_multichip(8, [(2, 4), (4, 2), (1, 8)], devices=cpus(8))
    out = capsys.readouterr().out
    assert out.count("dryrun topology ok") == 3 and "halo mode on 1x8" in out


def test_dryrun_refuses_too_few_devices():
    with pytest.raises(RuntimeError, match="need 4 devices, have 2"):
        dist.dryrun_multichip(4, devices=cpus(2))


# ---------------------------------------------------------------- devices


def test_default_mesh_takes_distinct_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert dist.local_devices() == [torch.device("cuda", i) for i in range(3)]
    mesh = dist.make_mesh(1, 3)
    assert mesh.shape == {"files": 1, "frames": 3} and len(set(mesh.devices)) == 3
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        dist.make_mesh(2, 2)
    assert dist.local_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        dist.make_mesh(1, 2, dist.local_devices("cpu"))


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        dist.make_mesh(1, 1)


def test_mesh_lists_a_device_only_when_asked():
    mesh = dist.make_mesh(2, 2, cpus(4))
    assert mesh.shape == {"files": 2, "frames": 2} and mesh.devices == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="rectangular"):
        dist.Mesh([["cpu", "cpu"], ["cpu"]])


def test_files_must_split_over_the_files_axis():
    frames, config = dist.dryrun_case(3, 4)
    with pytest.raises(ValueError, match="3 files do not split over a files axis of 2"):
        dist.sharded_analyze(frames, config, dist.make_mesh(2, 1, cpus(2)))
