"""voxtpu_torch.io_wav, the port's only WAV reader, against voxtpu.io_wav on
generated files of every format the reader takes: PCM 8/16/24/32, 24-in-32
WAVE_FORMAT_EXTENSIBLE, IEEE float 32/64 (plain and extensible), stereo,
and a data chunk shorter than its header says. Samples, rate and bit depth
are equal bit for bit, in float64 and float32; both readers refuse the same
bad files. (tests/test_torch_basics.py holds the fixtures equal.)
"""

import struct

import numpy as np
import pytest

from voxtpu import io_wav as jio
from voxtpu_torch import io_wav

_GUID_TAIL = bytes([0x00, 0x00, 0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71])


def _riff(fmt_chunk: bytes, payload: bytes, declared=None) -> bytes:
    n = len(payload) if declared is None else declared
    body = b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk + b"data" + struct.pack("<I", n) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body


def _fmt_plain(code, ch, sr, bits):
    block = ch * bits // 8
    return struct.pack("<HHIIHH", code, ch, sr, sr * block, block, bits)


def _fmt_extensible(sub_code, ch, sr, bits, valid, guid_tail=_GUID_TAIL):
    block = ch * bits // 8
    return (struct.pack("<HHIIHH", 0xFFFE, ch, sr, sr * block, block, bits) + struct.pack("<HHI", 22, valid, 0)
            + struct.pack("<H", sub_code) + guid_tail)


def _generated() -> dict:
    """{name: file bytes}, one file per format the reader takes."""
    rng = np.random.default_rng(1)
    i16 = rng.integers(-2**15, 2**15, 64).astype("<i2")
    i24 = rng.integers(-2**23, 2**23, 64)
    return {
        "pcm16": _riff(_fmt_plain(1, 1, 16000, 16), i16.tobytes()),
        "pcm8": _riff(_fmt_plain(1, 1, 8000, 8), rng.integers(0, 256, 64).astype(np.uint8).tobytes()),
        "pcm24": _riff(_fmt_plain(1, 1, 44100, 24), b"".join(struct.pack("<i", int(v))[:3] for v in i24)),
        "pcm32": _riff(_fmt_plain(1, 1, 48000, 32), rng.integers(-2**31, 2**31, 64).astype("<i4").tobytes()),
        "ext24in32": _riff(_fmt_extensible(1, 1, 16000, 32, 24), (i24.astype(np.int64) << 8).astype("<i4").tobytes()),
        "f32": _riff(_fmt_plain(3, 1, 22050, 32), rng.uniform(-2, 2, 64).astype("<f4").tobytes()),
        "f64": _riff(_fmt_plain(3, 1, 8000, 64), rng.uniform(-2, 2, 64).astype("<f8").tobytes()),
        "extf32": _riff(_fmt_extensible(3, 1, 22050, 32, 32), rng.uniform(-1, 1, 64).astype("<f4").tobytes()),
        "stereo16": _riff(_fmt_plain(1, 2, 11025, 16), i16.tobytes()),
        "truncated": _riff(_fmt_plain(1, 1, 16000, 16), i16.tobytes(), declared=10_000),
    }


GENERATED = _generated()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", sorted(GENERATED))
def test_every_format_reads_as_voxtpu_reads_it(name, dtype, tmp_path):
    path = tmp_path / f"{name}.wav"
    path.write_bytes(GENERATED[name])
    got, want = io_wav.read_wav(str(path), dtype=dtype), jio.read_wav(str(path), dtype=dtype)
    assert (got.sample_rate, got.bits_per_sample) == (want.sample_rate, want.bits_per_sample)
    assert got.samples.dtype == want.samples.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.samples, want.samples)
    assert io_wav.probe_wav_rate(str(path)) == jio.probe_wav_rate(str(path)) == got.sample_rate


@pytest.mark.parametrize("name, raw", [
    ("badguid", _riff(_fmt_extensible(1, 1, 8000, 16, 16, guid_tail=bytes([0xDE] * 14)), struct.pack("<4h", 1, 2, 3, 4))),
    ("alaw", _riff(_fmt_plain(6, 1, 8000, 8), bytes(8))),
    ("f16", _riff(_fmt_plain(3, 1, 8000, 16), bytes(8))),
    ("notwav", b"definitely not a wav"),
])
def test_both_readers_refuse_bad_files(name, raw, tmp_path):
    path = tmp_path / f"{name}.wav"
    path.write_bytes(raw)
    with pytest.raises(ValueError):
        jio.read_wav(str(path))
    with pytest.raises(ValueError):
        io_wav.read_wav(str(path))
