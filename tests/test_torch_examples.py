"""The examples of examples/torch/ on the CPU (`--device cpu`), held to
tests/test_examples.py's criteria for their voxtpu twins; pitch_detection's
printed f0 also against the voxtpu example's to 1e-3 Hz."""

import importlib.util
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(*parts):
    path = os.path.join(ROOT, "examples", *parts)
    spec = importlib.util.spec_from_file_location("example_" + "_".join(parts).replace(".py", ""), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f0s(out):
    lines = [line for line in out.splitlines() if line.startswith("frame")]
    assert lines, out
    # "frame 0: best f0 = 150.0000 Hz (strength ...)"
    return [float(line.split("=")[1].split("Hz")[0]) for line in lines]


def test_pitch_detection_example(capsys):
    _load("torch", "pitch_detection.py").main(["--device", "cpu"])
    got = _f0s(capsys.readouterr().out)
    assert abs(got[0] - 150.0) < 0.5, got
    _load("pitch_detection.py").main()
    want = _f0s(capsys.readouterr().out)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_serving_client_example(capsys):
    _load("torch", "serving_client.py").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "f0 track:" in out and "server stats: " in out, out
    # short_sample's f0 sits near 100 Hz (the wav-parity fixture truth).
    track = [float(v) for v in out.split("f0 track:")[1].splitlines()[0].split()]
    voiced = [v for v in track if v > 0]
    assert voiced and all(60 <= v <= 500 for v in voiced), track
    assert "streamed" in out and "viterbi f0 track:" in out, out


def test_formant_extraction_example(capsys):
    rc = _load("torch", "formant_extraction.py").main(["--device", "cpu"])
    assert rc in (0, None)
    out = capsys.readouterr().out
    rows = [line.split() for line in out.splitlines() if line and line[0].isdigit()]
    assert len(rows) > 50, f"expected gnuplot rows, got {len(rows)}"
    # Columns: time f1 f2 ... — F1 of the vowels should sit in speech range
    # at the 10 kHz analysis rate.
    f1 = np.asarray([float(r[1]) for r in rows])
    voiced = f1[f1 > 0]
    assert voiced.size > 0
    assert np.all((voiced > 50.0) & (voiced < 5001.0)), (voiced.min(), voiced.max())


@pytest.mark.parametrize("name", ["formant_extraction.py", "pitch_detection.py", "serving_client.py"])
def test_examples_default_to_the_card(name, monkeypatch, capsys):
    """Without --device an example runs on the card: with none, it raises
    NoCudaDevice (the command line's formant example prints it, exit 1)."""
    from voxtpu_torch.device import NoCudaDevice

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _load("torch", name)
    if name == "formant_extraction.py":
        assert mod.main([]) == 1
        assert "no CUDA device" in capsys.readouterr().err
    else:
        with pytest.raises(NoCudaDevice):
            mod.main([])
