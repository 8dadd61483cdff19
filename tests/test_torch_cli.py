"""`python -m voxtpu_torch analyze|corpus` (voxtpu_torch.cli) on the CPU,
mirroring tests/test_cli.py with `--device cpu`.

Against `voxtpu.cli.main` on the same inputs: `analyze -o` in float64
(without and with `--viterbi`, and through `--resample-hz` with both
methods), at tests/test_torch_pipeline.py's per-key tolerances; the
column printer, the channel reader, the bucket ladders and
`build_analysis_config`. The rest holds the port to itself at
tests/test_cli.py's tolerances: corpus resume, same-stem outputs,
format-aware resume, a corrupt file skipped, `--batch-files` equal to
serial, bucketed equal to unbucketed. One exception: `--batch-files`
against serial holds formants at tests/test_torch_pipeline.py's
tolerances (freqs rtol 1e-7 / atol 1e-5, bws rtol 1e-6 / atol 1e-4), not
1e-9. In float64 on the CPU, torch's sums take another path at another
batch shape, and bandwidths differ by up to 1.6e-9 relative (the
batched-plan class of PARITY deviation 5). Each voxtpu run happens once,
in a module fixture.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

import voxtpu.cli as jcli
from voxtpu_torch import cli as tcli
from voxtpu_torch.pipeline import config_from_jax

from test_torch_pipeline import _assert_key

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
WAV = os.path.join(FIXTURES, "short_sample.wav")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tmain(argv):
    """The port's CLI on the CPU."""
    return tcli.main(argv + ["--device", "cpu"])


def _write_sine_wav(path, freq, sr=11025, seconds=0.6):
    t = np.arange(int(sr * seconds)) / sr
    x = (0.7 * np.sin(2 * np.pi * freq * t) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


def _write_stereo_wav(path, f_left, f_right, sr=11025, seconds=0.5):
    t = np.arange(int(sr * seconds)) / sr
    left = (0.7 * np.sin(2 * np.pi * f_left * t) * 32767).astype("<i2")
    right = (0.7 * np.sin(2 * np.pi * f_right * t) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.stack([left, right], axis=1).tobytes())


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _both(tmp_path_factory, name, wav, extra):
    """`analyze wav -o x.npz` + extra through voxtpu and through the port."""
    d = tmp_path_factory.mktemp(name)
    assert jcli.main(["analyze", str(wav), "-o", str(d / "jax.npz")] + extra) == 0
    assert tmain(["analyze", str(wav), "-o", str(d / "torch.npz")] + extra) == 0
    return _npz(d / "torch.npz"), _npz(d / "jax.npz")


@pytest.fixture(scope="module")
def f64_pair(tmp_path_factory):
    return _both(tmp_path_factory, "f64", WAV, ["--f64", "--fmax", "500", "--n-coeffs", "10"])


@pytest.fixture(scope="module")
def order40_pair(tmp_path_factory):
    """LPC order 40, above the orders the card took before the roots and
    Burg kernels grew to 127: N = 41 polynomials, on the CPU as voxtpu runs
    any order."""
    return _both(tmp_path_factory, "order40", WAV, ["--f64", "--fmax", "500", "--n-coeffs", "40"])


@pytest.fixture(scope="module")
def viterbi_pair(tmp_path_factory):
    return _both(tmp_path_factory, "viterbi", WAV, ["--f64", "--viterbi"])


@pytest.fixture(scope="module")
def sine44k(tmp_path_factory):
    wav = tmp_path_factory.mktemp("sine") / "sine.wav"
    _write_sine_wav(wav, 150.0, sr=44100, seconds=0.4)
    return wav


@pytest.fixture(scope="module", params=["linear", "sinc"])
def resample_pair(request, tmp_path_factory, sine44k):
    # --viterbi: take-best on a pure sine picks the sub-octave; the path
    # search's octave cost resolves it (tests/test_cli.py:171-173).
    return _both(tmp_path_factory, f"resample_{request.param}", sine44k,
                 ["--f64", "--viterbi", "--resample-hz", "11025", "--resample-method", request.param,
                  "--fmin", "60", "--fmax", "400"]), request.param


KEYS = ["rms", "mfcc", "f0", "f0_strength", "hnr_db", "formant_freqs", "formant_bws", "status",
        "pitch_candidates_freq", "pitch_candidates_strength", "pitch_candidates_valid"]


@pytest.mark.parametrize("key", KEYS)
def test_analyze_f64_npz_matches_voxtpu(f64_pair, key):
    got, want = f64_pair
    assert got.keys() == want.keys()
    _assert_key(key, got, want, 11025.0)


@pytest.mark.parametrize("key", KEYS)
def test_analyze_order40_npz_matches_voxtpu(order40_pair, key):
    got, want = order40_pair
    assert got.keys() == want.keys()
    _assert_key(key, got, want, 11025.0)


@pytest.mark.parametrize("key", KEYS)
def test_analyze_viterbi_npz_matches_voxtpu(viterbi_pair, key):
    got, want = viterbi_pair
    assert got.keys() == want.keys()
    _assert_key(key, got, want, 11025.0)


def test_analyze_viterbi_is_healthy(viterbi_pair):
    got, _ = viterbi_pair
    assert got["f0"].dtype == np.float64 and got["f0"].shape == (21,)
    assert np.all((got["f0"] > 99.0) & (got["f0"] < 101.5)) and not got["status"].any()


@pytest.mark.parametrize("key", ["f0", "f0_strength", "rms", "mfcc", "formant_freqs", "status"])
def test_analyze_resample_matches_voxtpu(resample_pair, key):
    (got, want), method = resample_pair
    n = int(11025 * 0.4)
    assert got[key].shape[0] == (n - 552) // 111 + 1  # frames at the analysis rate
    _assert_key(key, got, want, 11025.0)
    voiced = got["f0"][got["f0"] > 0]
    assert len(voiced) >= got["f0"].shape[0] - 2
    np.testing.assert_allclose(voiced, 150.0, atol=2.5)


def test_analyze_columns_print_the_npz(tmp_path, capsys, f64_pair):
    """The columns are the npz's features through voxtpu's printer: the same
    text from both packages' `_print_columns` on the same dict."""
    assert tmain(["analyze", WAV, "--f64", "--fmax", "500", "--n-coeffs", "10"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 21 and all(len(line.split()) == 11 for line in lines)  # time + 4 x (freq bw) + rms + f0
    got, want = f64_pair
    cfg = tcli.build_analysis_config(11025.0)
    buf_t, buf_j = io.StringIO(), io.StringIO()
    tcli._print_columns(got, cfg.hop, cfg.sample_rate, file=buf_t)
    jcli._print_columns(got, cfg.hop, cfg.sample_rate, file=buf_j)
    assert buf_t.getvalue().strip().splitlines() == lines == buf_j.getvalue().strip().splitlines()
    jbuf = io.StringIO()
    jcli._print_columns(want, cfg.hop, cfg.sample_rate, file=jbuf)
    a = np.array([[float(c) for c in line.split()] for line in lines])
    b = np.array([[float(c) for c in line.split()] for line in jbuf.getvalue().strip().splitlines()])
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-3)


def test_float32_default_within_budget_of_f64(tmp_path, f64_pair):
    """Without --f64 the port writes float32 (bucketed to the 64 rung),
    within tests/test_fast_mode.py:62-69's budgets of its float64 run."""
    out = tmp_path / "f32.npz"
    assert tmain(["analyze", WAV, "--fmax", "500", "--n-coeffs", "10", "-o", str(out)]) == 0
    f32, (f64, _) = _npz(out), f64_pair
    assert f32["f0"].dtype == np.float32 and f32["f0"].shape == f64["f0"].shape
    voiced = f64["f0"] > 0
    for key, atol in {"f0": 0.3, "f0_strength": 8e-3, "formant_freqs": 1.0, "mfcc": 1e-4}.items():
        a, b = f32[key].astype(np.float64), f64[key]
        if key == "f0":
            a, b = a[voiced], b[voiced]
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=key)


def test_channel_reader_matches_voxtpu(tmp_path, capsys):
    wav = tmp_path / "stereo.wav"
    _write_stereo_wav(wav, 150.0, 250.0)
    for channel in ("0", "1", "mix"):
        for dt in (np.float32, np.float64):
            got, sr_t = tcli._read(str(wav), dt, channel)
            want, sr_j = jcli._read(str(wav), dt, channel)
            assert sr_t == sr_j and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    err = capsys.readouterr().err
    assert "2-channel input, using channel 1" in err and "mixing down" in err
    for bad in ("2", "-1"):
        with pytest.raises(IndexError):
            tcli._read(str(wav), np.float64, bad)


def test_analyze_stereo_channel_flag(tmp_path, capsys):
    wav = tmp_path / "stereo.wav"
    _write_stereo_wav(wav, 150.0, 250.0)

    def f0_of(extra):
        out = tmp_path / "f.npz"
        assert tmain(["analyze", str(wav), "-o", str(out), "--f64", "--viterbi", "--fmin", "100",
                      "--fmax", "400"] + extra) == 0
        z = _npz(out)
        return float(np.median(z["f0"][z["f0"] > 0]))

    assert abs(f0_of([]) - 150.0) < 3.0
    assert "2-channel input" in capsys.readouterr().err
    assert abs(f0_of(["--channel", "1"]) - 250.0) < 3.0
    assert np.isfinite(f0_of(["--channel", "mix"]))
    assert "mixing down" in capsys.readouterr().err
    assert tmain(["analyze", str(wav), "--f64", "--channel", "5"]) == 1
    assert "out of range" in capsys.readouterr().err


def test_analyze_unreadable_file(tmp_path, capsys):
    bad = tmp_path / "bad.wav"
    bad.write_text("not a wav")
    assert tmain(["analyze", str(bad), "--f64"]) == 1
    assert "cannot read" in capsys.readouterr().err


def test_analyze_plot_and_parquet(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    png, pqt = tmp_path / "plot.png", tmp_path / "f.parquet"
    assert tmain(["analyze", WAV, "--fmax", "500", "--f64", "--plot", str(png)]) == 0
    assert png.stat().st_size > 5000
    assert tmain(["analyze", WAV, "--fmax", "500", "--f64", "-o", str(pqt)]) == 0
    table = pq.read_table(pqt)
    assert table.num_rows == 21 and "formant_freqs" in table.column_names


def test_corpus_resume(tmp_path, capsys):
    outdir = tmp_path / "features"
    assert tmain(["corpus", WAV, "-o", str(outdir), "--f64"]) == 0
    manifest = json.loads((outdir / "manifest.json").read_text())
    assert manifest[WAV]["frames"] == 21 and manifest[WAV]["status_nonzero"] == 0
    assert tmain(["corpus", WAV, "-o", str(outdir), "--f64"]) == 0
    assert "resume skip" in capsys.readouterr().err


def test_corpus_resume_respects_format(tmp_path):
    pytest.importorskip("pyarrow")
    outdir = tmp_path / "both"
    assert tmain(["corpus", WAV, "-o", str(outdir), "--f64"]) == 0
    assert (outdir / "short_sample.npz").exists()
    assert tmain(["corpus", WAV, "-o", str(outdir), "--f64", "--format", "parquet"]) == 0
    assert (outdir / "short_sample.parquet").exists()
    manifest = json.loads((outdir / "manifest.json").read_text())
    assert manifest[WAV]["output"].endswith(".parquet")


def test_corpus_same_stem_no_overwrite(tmp_path):
    d1, d2 = tmp_path / "spk1", tmp_path / "spk2"
    d1.mkdir(), d2.mkdir()
    _write_sine_wav(d1 / "take.wav", 150.0, seconds=0.4)
    _write_sine_wav(d2 / "take.wav", 190.0, seconds=0.4)
    outdir = tmp_path / "features"
    # --fmin 100 keeps each sine's sub-octave out of band (tests/test_cli.py:214-216).
    assert tmain(["corpus", str(d1 / "take.wav"), str(d2 / "take.wav"), "-o", str(outdir), "--f64",
                  "--fmin", "100", "--batch-files", "2"]) == 0
    manifest = json.loads((outdir / "manifest.json").read_text())
    out1, out2 = manifest[str(d1 / "take.wav")]["output"], manifest[str(d2 / "take.wav")]["output"]
    assert out1 != out2
    assert abs(np.median(_npz(outdir / out1)["f0"]) - 150.0) < 3.0
    assert abs(np.median(_npz(outdir / out2)["f0"]) - 190.0) < 3.0


def test_corpus_skips_corrupt_file(tmp_path, capsys):
    wavdir = tmp_path / "wavs"
    wavdir.mkdir()
    _write_sine_wav(wavdir / "good.wav", 200.0, seconds=0.4)
    (wavdir / "bad.wav").write_bytes(b"RIFFxxxxWAVEfmt corrupted!!")
    outdir = tmp_path / "out"
    assert tmain(["corpus", str(wavdir / "*.wav"), "-o", str(outdir), "--f64"]) == 0
    err = capsys.readouterr().err
    assert "read error" in err or "skipping" in err, err
    manifest = json.loads((outdir / "manifest.json").read_text())
    assert manifest[str(wavdir / "good.wav")]["frames"] > 0
    assert "error" in manifest[str(wavdir / "bad.wav")]
    assert (outdir / "good.npz").exists() and not (outdir / "bad.npz").exists()


@pytest.mark.parametrize("extra", [[], ["--viterbi"]])
def test_corpus_batch_files_matches_serial(tmp_path, extra):
    """Three mixed-length files in blocks of 2 (the last block padded with
    an empty file) equal the per-file path (tests/test_cli.py:127-161)."""
    wavdir = tmp_path / "wavs"
    wavdir.mkdir()
    _write_sine_wav(wavdir / "x.wav", 190.0, seconds=0.45)
    _write_sine_wav(wavdir / "y.wav", 260.0, seconds=0.62)
    _write_sine_wav(wavdir / "z.wav", 330.0, seconds=0.57)
    outb, outs = tmp_path / "batched", tmp_path / "serial"
    assert tmain(["corpus", str(wavdir / "*.wav"), "-o", str(outb), "--f64", "--batch-files", "2", "--no-resume"]
                 + extra) == 0
    assert tmain(["corpus", str(wavdir / "*.wav"), "-o", str(outs), "--f64", "--batch-files", "1", "--no-resume"]
                 + extra) == 0
    for name in ("x", "y", "z"):
        zb, zs = _npz(outb / f"{name}.npz"), _npz(outs / f"{name}.npz")
        assert zb.keys() == zs.keys()
        for k in ("rms", "mfcc", "status"):
            np.testing.assert_allclose(zb[k], zs[k], rtol=1e-9, atol=1e-12, err_msg=f"{name}:{k}")
        np.testing.assert_allclose(zb["formant_freqs"], zs["formant_freqs"], rtol=1e-7, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(zb["formant_bws"], zs["formant_bws"], rtol=1e-6, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(zb["f0"], zs["f0"], rtol=1e-6, err_msg=name)
        if extra:
            np.testing.assert_allclose(zb["f0_strength"], zs["f0_strength"], rtol=1e-6, err_msg=name)


def test_bucket_frames_outputs_match_unbucketed(tmp_path):
    wav = os.path.join(FIXTURES, "sample-two_vowels.wav")
    a, b = tmp_path / "bucketed.npz", tmp_path / "plain.npz"
    assert tmain(["analyze", wav, "--fmax", "500", "--bucket-frames", "64", "-o", str(a)]) == 0
    assert tmain(["analyze", wav, "--fmax", "500", "--bucket-frames", "0", "-o", str(b)]) == 0
    xa, xb = _npz(a), _npz(b)
    assert xa.keys() == xb.keys()
    for k in xb:
        assert xa[k].shape == xb[k].shape, k
        if xb[k].dtype.kind == "f":
            np.testing.assert_allclose(xa[k], xb[k], rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)


def test_bucket_ladders_match_voxtpu():
    for bucket in (0, 16, 64, 256, 1024, 4096):
        for F in range(1, 2100, 7):
            assert tcli._bucket_target(F, bucket) == jcli._bucket_target(F, bucket), (F, bucket)
            assert tcli._bucket_target_fine(F, bucket) == jcli._bucket_target_fine(F, bucket), (F, bucket)
    for bucket_frames in (None, 0, 64):
        for f64 in (True, False):
            ns = argparse.Namespace(bucket_frames=bucket_frames, f64=f64)
            assert tcli._resolve_bucket(ns) == jcli._resolve_bucket(ns)


@pytest.mark.parametrize("rate", [11025.0, 16000.0, 44100.0])
def test_build_analysis_config_matches_voxtpu(rate):
    assert tcli.build_analysis_config(rate) == config_from_jax(jcli.build_analysis_config(rate))
    kw = dict(frame_ms=30.0, hop_ms=5.0, features="pitch,mfcc", fmin=80.0, fmax=400.0, threshold=0.3,
              n_coeffs=10, mfcc_coeffs=12, pitch_refine="parabolic", refine_depth=70, resample_hz=8000.0)
    assert tcli.build_analysis_config(rate, **kw) == config_from_jax(jcli.build_analysis_config(rate, **kw))


def test_cli_rejects_feature_typo(capsys):
    assert tcli.main(["analyze", WAV, "--features", "pitch,formnts"]) == 2
    err = capsys.readouterr().err
    assert "formnts" in err and "unknown feature" in err


@pytest.mark.parametrize("argv", [
    ["serve", "--resample-hz", "16000"], ["serve", "--f64"], ["bench"],
    ["serve", "--data-parallel", "2", "--device", "cpu"],
])
def test_serve_and_bench_not_yet_ported(argv, capsys, monkeypatch):
    """`serve` refuses --resample-hz and --f64 with voxtpu's messages, card
    or not, and --data-parallel above the device count (the CPU is one
    device): exit 2. `bench` is ported (tests/test_torch_bench.py): without
    a card it prints the NoCudaDevice error and exits 1, as every command
    does, and no longer 2."""
    if argv == ["bench"]:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tcli.main(argv) == 1
        assert "no CUDA device" in capsys.readouterr().err
        return
    assert tcli.main(argv) == 2
    err = capsys.readouterr().err
    if argv[1:2] in (["--resample-hz"], ["--f64"]):
        assert jcli.main(argv) == 2
        assert err == capsys.readouterr().err
    else:
        assert "data_parallel 2 > 1 devices" in err


def test_sharded_mesh_takes_every_card(monkeypatch):
    """`corpus --sharded` shards over every card, each once."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tcli._sharded_devices(torch.device("cuda")) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tcli._sharded_devices(torch.device("cpu")) == [torch.device("cpu")]


def _sharded_pair(tmp_path, monkeypatch, wavs: dict, extra=()):
    """`corpus --sharded` over the CPU listed twice, and the serial
    `corpus` (one file at a time) of the same WAVs, float64: their output
    directories."""
    wavdir = tmp_path / "wavs"
    wavdir.mkdir()
    for name, (f, secs) in wavs.items():
        _write_sine_wav(wavdir / f"{name}.wav", f, seconds=secs)
    monkeypatch.setattr(tcli, "_sharded_devices", lambda device: [torch.device("cpu")] * 2)
    sharded, serial = tmp_path / "sharded", tmp_path / "serial"
    glob_ = str(wavdir / "*.wav")
    assert tmain(["corpus", glob_, "-o", str(sharded), "--f64", "--sharded", "--no-resume", *extra]) == 0
    assert tmain(["corpus", glob_, "-o", str(serial), "--f64", "--batch-files", "1", "--no-resume", *extra]) == 0
    return sharded, serial


@pytest.mark.parametrize("n_files, mesh", [(1, {"files": 1, "frames": 2}), (3, {"files": 2, "frames": 1})])
def test_corpus_sharded_matches_serial(tmp_path, monkeypatch, n_files, mesh):
    """The sharded block loop over a mesh of two listed CPUs equals the
    serial command per file (tests/test_cli.py:70-101's tolerances): one
    file shards its frames (1x2); three take the files axis (2x1), the
    second block padded with a zero file. The manifest records the mesh."""
    wavs = dict(list({"a": (160.0, 0.45), "b": (220.0, 0.5), "c": (280.0, 0.55)}.items())[:n_files])
    sharded, serial = _sharded_pair(tmp_path, monkeypatch, wavs)
    manifest = json.loads((sharded / "manifest.json").read_text())
    assert [v["mesh"] for v in manifest.values()] == [mesh] * n_files
    for name in wavs:
        z, z2 = _npz(sharded / f"{name}.npz"), _npz(serial / f"{name}.npz")
        assert z.keys() == z2.keys()
        for k in ("formant_freqs", "formant_bws", "rms", "mfcc", "status"):
            np.testing.assert_allclose(z[k], z2[k], rtol=1e-9, err_msg=f"{name}:{k}")
        np.testing.assert_allclose(z["f0"], z2["f0"], rtol=1e-6, err_msg=name)


def test_corpus_sharded_viterbi(tmp_path, monkeypatch):
    """--viterbi on the sharded loop: each file's path over its own trimmed
    candidates (tests/test_cli.py:103-126)."""
    sharded, serial = _sharded_pair(tmp_path, monkeypatch, {"x": (190.0, 0.5), "y": (260.0, 0.7)}, ["--viterbi"])
    for name in ("x", "y"):
        z, z2 = _npz(sharded / f"{name}.npz"), _npz(serial / f"{name}.npz")
        np.testing.assert_allclose(z["f0"], z2["f0"], rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(z["f0_strength"], z2["f0_strength"], rtol=1e-6, err_msg=name)


def test_corpus_sharded_bucketed_matches_serial(tmp_path, monkeypatch):
    """--sharded with --bucket-frames 16: blocks pad to the bucket on the
    mesh, files still equal the serial bucketed run (tests/test_cli.py:
    280-300)."""
    wavs = {"p": (170.0, 0.45), "q": (230.0, 0.6), "r": (310.0, 0.52)}
    sharded, serial = _sharded_pair(tmp_path, monkeypatch, wavs, ["--bucket-frames", "16"])
    for name in wavs:
        z, z2 = _npz(sharded / f"{name}.npz"), _npz(serial / f"{name}.npz")
        assert z["rms"].shape == z2["rms"].shape, name
        for k in ("formant_freqs", "rms", "status"):
            np.testing.assert_allclose(z[k], z2[k], rtol=1e-9, err_msg=f"{name}:{k}")
        np.testing.assert_allclose(z["f0"], z2["f0"], rtol=1e-6, err_msg=name)


def test_sharded_on_one_device_runs_serial(tmp_path, capsys):
    outdir = tmp_path / "sh"
    assert tmain(["corpus", WAV, "-o", str(outdir), "--f64", "--sharded"]) == 0
    assert "only 1 device; running serial" in capsys.readouterr().err
    assert (outdir / "short_sample.npz").exists()


def test_without_a_card_the_command_refuses(capsys):
    """The default device is the card: with none the command prints the
    NoCudaDevice error and exits 1 instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would run there")
    assert tcli.main(["analyze", WAV]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_serve_command_answers_and_stops_on_sigint(tmp_path):
    """`python -m voxtpu_torch serve --device cpu` in a new process: warm-up,
    its "serving on" line, one WAV answered as the in-process analysis
    answers it, and exit 0 on SIGINT."""
    import select
    import signal
    import urllib.request

    from voxtpu_torch.pipeline import analyze

    wav = tmp_path / "a.wav"
    _write_sine_wav(wav, 220.0, sr=8000, seconds=0.5)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "voxtpu_torch", "serve", "--port", "0", "--device", "cpu",
                             "--allowed-rates", "8000", "--bucket-frames", "64", "--max-batch", "1"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline() if select.select([proc.stdout], [], [], 120)[0] else ""
        assert line.startswith("voxtpu serving on http://127.0.0.1:"), (line, proc.stderr.read() if proc.poll() else "")
        url = line.split()[3]
        req = urllib.request.Request(f"{url}/analyze?format=npz", data=wav.read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = np.load(io.BytesIO(r.read()))
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    samples, sr = tcli._read(str(wav), np.float32)
    want = analyze(torch.as_tensor(samples), tcli.build_analysis_config(sr))
    for k in ("f0", "rms", "formant_freqs", "mfcc", "status"):
        np.testing.assert_allclose(got[k], want[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    assert "warming up" in proc.stderr.read()


def test_module_entry_point(tmp_path):
    """`python -m voxtpu_torch analyze` in a new process equals the
    in-process command."""
    out, ref = tmp_path / "sub.npz", tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "voxtpu_torch", "analyze", WAV, "--f64", "--device", "cpu",
                           "-o", str(out)], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert tmain(["analyze", WAV, "--f64", "-o", str(ref)]) == 0
    a, b = _npz(out), _npz(ref)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
