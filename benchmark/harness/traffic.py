"""Traffic: a pool of corpus blocks made from the seed, as `corpus
--batch-files N` builds them, and the order the window visits them in.

A mix file (`benchmark/traffic/<mix>.json`) fixes:
- `recordings_per_block`, `blocks`: the pool holds blocks x
  recordings_per_block recordings;
- `seconds_min`, `seconds_max`: the recordings' lengths, the stratified
  quantiles (i + 1/2) / N of that range, so every seed has the same
  multiset of lengths, the same padding and the same block shapes;
- `gain_min`, `gain_max`: each recording's gain is drawn from that range;
- `bucket_frames`, `trim_step`: the frame-axis ladder and the fetch trim;
- `check_blocks`: how many of the window's blocks the check compares;
- `trace_blocks`: how many blocks the traced stretch runs.

Each recording is the speech fixture tiled from a seeded start offset, cut
to its length and scaled by its gain, in float32. Recordings are sorted by
length and cut into blocks of `recordings_per_block` rows; the frame axis
is padded to the ladder's rung and the fetch trimmed to `trim_step`-frame
steps (`voxtpu_torch.cli`'s corpus block loop). The seed moves the offsets,
the gains and the visiting order only.
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parents[1] / "data" / "sample-two_vowels.wav"
# Rungs below the top bucket of the dense ladder of corpus blocks.
LADDER_FINE = (64, 128, 192, 256, 384, 512, 640, 768, 896)


def bucket_target_fine(F: int, bucket: int) -> int:
    """The padded frame count of a block whose longest recording has F
    frames: the first rung below `bucket` that holds it, else the next
    multiple of `bucket`. 0 disables."""
    if not bucket or F % bucket == 0:
        return F
    for rung in LADDER_FINE:
        if rung < bucket and F <= rung:
            return rung
    return (F + bucket - 1) // bucket * bucket


def num_frames(n_samples: int, frame_len: int, hop: int) -> int:
    return max((n_samples - frame_len) // hop + 1, 0)


def read_fixture(path: Path = FIXTURE) -> tuple[np.ndarray, float]:
    """The fixture's 16-bit mono samples as float32 in [-1, 1), and its rate."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: expected 16-bit mono PCM")
        raw = w.readframes(w.getnframes())
        rate = float(w.getframerate())
    return (np.frombuffer(raw, dtype="<i2").astype(np.float32) / np.float32(32768.0)), rate


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def lengths_s(mix: dict) -> np.ndarray:
    """The pool's recording lengths in seconds, ascending."""
    n = mix["recordings_per_block"] * mix["blocks"]
    q = (np.arange(n) + 0.5) / n
    return mix["seconds_min"] + (mix["seconds_max"] - mix["seconds_min"]) * q


@dataclass
class Block:
    """One pool block: (B, S) samples and (B,) lengths as host arrays (views
    of the page-locked tensors in `pinned`, where the pool is pinned), each
    recording's frame count, the padded frame axis, the fetch's trim, and
    the seconds of audio the block holds."""

    samples: np.ndarray
    lengths: np.ndarray
    frames: list
    padded_frames: int
    trim: int
    audio_s: float
    pinned: tuple | None = None


def make_pool(mix: dict, cfg: dict, seed: int, pinned: bool = False) -> list[Block]:
    """The pool of blocks for `seed` (see the module docstring). With
    `pinned` each block's buffers are page-locked torch tensors."""
    one, rate = read_fixture()
    sr, n, hop = cfg["sample_rate"], cfg["frame_len"], cfg["hop"]
    if rate != sr:
        raise ValueError(f"fixture rate {rate} differs from the configuration's {sr}")
    rng = rng_for(seed, 0)
    lens = np.round(lengths_s(mix) * sr).astype(np.int64)
    offsets = rng.integers(0, one.shape[0], lens.shape[0])
    gains = rng.uniform(mix["gain_min"], mix["gain_max"], lens.shape[0]).astype(np.float32)
    R = mix["recordings_per_block"]
    step = mix["trim_step"]
    pool = []
    for b0 in range(0, lens.shape[0], R):
        idx = range(b0, b0 + R)
        nfs = [num_frames(int(lens[i]), n, hop) for i in idx]
        f_true = max(nfs)
        f_pad = bucket_target_fine(f_true, mix["bucket_frames"])
        S = (f_pad - 1) * hop + n
        trim = min(f_pad, max(step, (f_true + step - 1) // step * step))
        tensors = None
        if pinned:
            import torch

            tensors = (torch.empty((R, S), dtype=torch.float32, pin_memory=True),
                       torch.empty((R,), dtype=torch.int64, pin_memory=True))
            samples, lengths = tensors[0].numpy(), tensors[1].numpy()
        else:
            samples, lengths = np.empty((R, S), np.float32), np.empty((R,), np.int64)
        for row, i in enumerate(idx):
            m = min(int(lens[i]), S)
            _tile_into(samples[row, :m], one, int(offsets[i]), gains[i])
            samples[row, m:] = 0.0
            lengths[row] = m
        pool.append(Block(samples, lengths, nfs, f_pad, trim, float(lengths.sum()) / sr, tensors))
    return pool


def _tile_into(dst: np.ndarray, one: np.ndarray, offset: int, gain: np.float32) -> None:
    """dst[:] = gain * the fixture tiled from `offset`."""
    rolled = np.concatenate([one[offset:], one[:offset]]) * gain
    for s0 in range(0, dst.shape[0], rolled.shape[0]):
        k = min(rolled.shape[0], dst.shape[0] - s0)
        dst[s0 : s0 + k] = rolled[:k]


def visits(n_blocks: int, seed: int, stream: int = 1):
    """Pool indices without end: seeded permutations of the pool, one after
    another, so that every block comes once in each pass."""
    rng = rng_for(seed, stream)
    while True:
        yield from (int(i) for i in rng.permutation(n_blocks))
