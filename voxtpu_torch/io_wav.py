"""WAV ingest with reference-exact bit-depth normalization.

The reference reads WAVs via `hound` and normalizes integer samples as
`s / (i32::MAX >> (32 - bits))` (`vox_box tests/lib.rs:17-19`), i.e.
/32767 for 16-bit audio. (The formant example's `<<` variant,
examples/formant_extraction/src/main.rs:43, overflow-shifts into a negative
divisor and is a reference bug; we implement the tests' `>>` convention.)

The parser is a self-contained RIFF walker rather than stdlib `wave`, because
real-world corpora contain formats `wave` mishandles or rejects:
WAVE_FORMAT_EXTENSIBLE (0xFFFE) with wValidBitsPerSample < container width
(e.g. 24-in-32 — decoding at the container scale is silently wrong by 256x)
and WAVE_FORMAT_IEEE_FLOAT (3). Both are supported.

This is the pure-Python RIFF path of voxtpu.io_wav, copied so the port never
imports voxtpu (whose package import pulls in JAX). voxtpu's native C++
loader has no counterpart: this walker decodes with np.frombuffer.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

__all__ = ["WavData", "probe_wav_rate", "read_wav", "read_wav_bytes"]

I32_MAX = 2**31 - 1

# KSDATAFORMAT_SUBTYPE_* GUID bytes 2..15 (bytes 0-1 hold the format code).
_SUBFORMAT_GUID_TAIL = bytes(
    [0x00, 0x00, 0x00, 0x00, 0x10, 0x00, 0x80, 0x00,
     0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71]
)


@dataclass
class WavData:
    samples: np.ndarray  # (n,) or (n, channels) float in [-1, 1]
    sample_rate: int
    bits_per_sample: int  # significant (valid) bits for PCM; container for float

    @property
    def duration(self) -> float:
        return self.samples.shape[0] / self.sample_rate


def _parse_riff(raw: bytes):
    """Walk the RIFF chunks: returns (format, channels, sample_rate,
    container_bits, valid_bits, data bytes). format is resolved to 1 (integer
    PCM) or 3 (IEEE float); WAVE_FORMAT_EXTENSIBLE is resolved through its
    SubFormat GUID + wValidBitsPerSample."""
    if len(raw) < 12 or raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        ck_id = raw[pos : pos + 4]
        (ck_len,) = struct.unpack_from("<I", raw, pos + 4)
        body = pos + 8
        if ck_id == b"fmt " and body + 16 <= len(raw):
            code, channels, sr, _byte_rate, _block, container = struct.unpack_from(
                "<HHIIHH", raw, body
            )
            valid = container
            if code == 0xFFFE:
                if ck_len < 40 or body + 40 > len(raw):
                    raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
                (vb,) = struct.unpack_from("<H", raw, body + 18)
                if vb:
                    valid = vb
                if raw[body + 26 : body + 40] != _SUBFORMAT_GUID_TAIL:
                    raise ValueError("unknown WAVE_FORMAT_EXTENSIBLE SubFormat GUID")
                (code,) = struct.unpack_from("<H", raw, body + 24)
            if code not in (1, 3):
                raise ValueError(f"unsupported WAV format code: {code}")
            fmt = (code, channels, sr, container, valid)
        elif ck_id == b"data":
            data = raw[body : body + ck_len]
        pos = body + ck_len + (ck_len & 1)
    if fmt is None or data is None:
        raise ValueError("missing fmt or data chunk")
    return fmt + (data,)


def probe_wav_rate(path: str) -> float:
    """Sample rate from the WAV header alone — seeks chunk to chunk, never
    reads sample data (O(1) memory for corpus pass-1 grouping).

    Deliberately NOT stdlib `wave`: that rejects WAVE_FORMAT_IEEE_FLOAT (and,
    before Python 3.12, WAVE_FORMAT_EXTENSIBLE), so a `wave`-based probe would
    permanently skip corpus files the full readers here decode fine. The probe
    does not validate the format code — pass 2's real read reports any
    unsupported file with the decoder's own error."""
    with open(str(path), "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError("missing fmt chunk")
            (ck_len,) = struct.unpack_from("<I", hdr, 4)
            if hdr[:4] == b"fmt ":
                body = f.read(16)
                if len(body) < 16:
                    raise ValueError("truncated fmt chunk")
                return float(struct.unpack_from("<I", body, 4)[0])
            f.seek(ck_len + (ck_len & 1), 1)


def read_wav(path: str, dtype=np.float64) -> WavData:
    """Read a PCM / IEEE-float / extensible WAV, normalized like the
    reference's test harness (valid-bits-aware for extensible files)."""
    with open(str(path), "rb") as f:
        raw = f.read()
    return read_wav_bytes(raw, dtype=dtype)


def read_wav_bytes(raw: bytes, dtype=np.float64) -> WavData:
    """Decode an in-memory WAV (the serving ingest path: request bodies never
    touch the filesystem). Identical semantics to `read_wav`."""
    code, ch, sr, container, valid, payload = _parse_riff(raw)
    if ch == 0:
        raise ValueError("zero channels")
    # Tolerate a truncated data chunk (a declared ck_len past EOF — common in
    # interrupted recordings): decode the integral sample prefix that exists.
    sw = container // 8
    if sw:
        payload = payload[: len(payload) // sw * sw]

    if code == 3:  # IEEE float: already normalized
        if valid != container:
            raise ValueError(f"float WAV with partial valid bits: {valid}/{container}")
        if container == 32:
            data = np.frombuffer(payload, dtype="<f4")
        elif container == 64:
            data = np.frombuffer(payload, dtype="<f8")
        else:
            raise ValueError(f"unsupported float WAV width: {container}")
        n = len(data) // ch * ch
        samples = data[:n].astype(dtype)
        bits = container
    else:
        if container not in (8, 16, 24, 32):
            raise ValueError(f"unsupported PCM container width: {container}")
        if sw == 2:
            data = np.frombuffer(payload, dtype="<i2").astype(np.int64)
        elif sw == 4:
            data = np.frombuffer(payload, dtype="<i4").astype(np.int64)
        elif sw == 1:
            # 8-bit WAV is unsigned; recenter.
            data = np.frombuffer(payload, dtype=np.uint8).astype(np.int64) - 128
        elif sw == 3:
            b = np.frombuffer(payload[: len(payload) // 3 * 3], dtype=np.uint8)
            b = b.reshape(-1, 3)
            data = (
                b[:, 0].astype(np.int64)
                | (b[:, 1].astype(np.int64) << 8)
                | (b[:, 2].astype(np.int64) << 16)
            )
            data = np.where(data >= 1 << 23, data - (1 << 24), data)
        else:
            raise ValueError(f"unsupported sample width: {sw}")
        if not (1 <= valid <= container):
            raise ValueError(f"invalid wValidBitsPerSample: {valid}/{container}")
        # Extensible data is left-justified: drop the low padding bits, then
        # normalize at the VALID width (tests/lib.rs:17-19 convention).
        data = data >> (container - valid)
        scale = I32_MAX >> (32 - valid)
        n = len(data) // ch * ch
        samples = (data[:n] / scale).astype(dtype)
        bits = valid

    if ch > 1:
        samples = samples.reshape(-1, ch)
    return WavData(samples=samples, sample_rate=sr, bits_per_sample=bits)
