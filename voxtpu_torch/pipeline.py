"""The per-file analysis pipeline: pitch + formants + MFCC + RMS.

Port of voxtpu.pipeline's one-recording path. `analyze(samples, config)`
frames a 1-D signal and `analyze_frames` computes every feature over the
(F, n) frames: pitch and MFCC on Hann-windowed frames, formants on the raw
frames (find_formants windows internally), RMS on the raw frames, and with
`PitchConfig.viterbi` the path search over the pitch candidates. Work runs
in the input's dtype: float64 is the parity mode, float32 the working type
on the card. Seven CUDA kernels carry the card path (ct_fused for power-of-two
frames, pitch_pre, refine, burg, find_roots, formant_scan, and viterbi; see
voxtpu_torch.ops).

Entry points, each with a `device` argument (voxtpu_torch.device.as_input:
a tensor keeps its device, anything else goes to the card unless
device="cpu"):
- `analyze`: one recording;
- `analyze_batch`: (B, F, n) frames of B recordings, the frame-parallel
  stages as one batch, one kernel-D and one kernel-F launch for all;
- `analyze_batch_padded`: (B, S) zero-padded signals with their lengths,
  the corpus-block entry point; `analyze_batch_padded_fetch` returns it as
  NumPy arrays through one packed buffer and one device-to-host copy;
- `analyze_long`: a Python loop over chunks of frames that threads the
  formant carry, with the path search once at the end;
- `StreamAnalyzer` / `analyze_stream` / `finalize_viterbi`: push-style
  streaming with the same carry, and the path search at end of stream.

`config_from_jax` reads a `voxtpu.pipeline.AnalysisConfig` (by attribute,
without importing voxtpu) into this module's dataclasses.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import numpy as np
import torch

from voxtpu_torch import errors, waves
from voxtpu_torch.autocorr import power_and_autocorrelate
from voxtpu_torch.device import as_input, constant
from voxtpu_torch.formants import (
    MALE_FORMANT_ESTIMATES, find_formants, formant_candidates, formant_tracker_batched,
)
from voxtpu_torch.frame import frame_signal, num_frames
from voxtpu_torch.mfcc import mfcc
from voxtpu_torch.pitch import pitch_frames
from voxtpu_torch.viterbi import PathConfig, pitch_path
from voxtpu_torch.windows import hann

__all__ = [
    "PitchConfig", "FormantConfig", "MfccConfig", "AnalysisConfig", "CLI_DEFAULT_44K",
    "BENCH_44K", "FLAGSHIP_44K", "config_from_jax", "f0_outputs", "f0_outputs_host",
    "analyze_frames", "analyze", "analyze_batch", "analyze_batch_padded", "analyze_long",
    "StreamAnalyzer", "analyze_stream", "finalize_viterbi",
    "analyze_batch_padded_fetch",
]


@dataclass(frozen=True)
class PitchConfig:
    enabled: bool = True
    threshold: float = 0.2
    fmin: float = 60.0
    fmax: float = 600.0
    max_candidates: int = 32
    #: run the Viterbi path search (voxtpu_torch.viterbi) and report its
    #: track as f0 instead of the strongest candidate
    viterbi: bool = False
    #: "sinc" (Brent over windowed sinc, periodic.rs:440-450) or "parabolic"
    refine: str = "sinc"
    #: cap on the refine pass's sinc depth; None = the reference's 1200
    refine_depth: int | None = None


@dataclass(frozen=True)
class FormantConfig:
    enabled: bool = True
    n_coeffs: int = 13
    resample_ratio: float = 1.0
    estimates: tuple = MALE_FORMANT_ESTIMATES
    estimate_bandwidth: float = 1.0
    #: compensated-Newton root polish in float32 (no-op in float64)
    polish: bool = True


@dataclass(frozen=True)
class MfccConfig:
    enabled: bool = True
    num_coeffs: int = 13
    freq_lo: float = 100.0
    freq_hi: float = 5000.0
    preemphasis_factor: float | None = None
    exact: bool = True


@dataclass(frozen=True)
class AnalysisConfig:
    sample_rate: float = 11025.0
    frame_len: int = 1024
    hop: int = 512
    pitch: PitchConfig = field(default_factory=PitchConfig)
    formant: FormantConfig = field(default_factory=FormantConfig)
    mfcc: MfccConfig = field(default_factory=MfccConfig)


#: `voxtpu.cli.build_analysis_config(44100.0)` with its defaults, the
#: configuration `python -m voxtpu analyze|corpus` and `serve` run on 44.1 kHz
#: audio: 50 ms frames (2205 samples), 10 ms hop (441), every feature on.
CLI_DEFAULT_44K = AnalysisConfig(
    sample_rate=44100.0,
    frame_len=int(math.ceil(44100.0 * 50.0 / 1000.0)),
    hop=int(math.ceil(44100.0 * 10.0 / 1000.0)),
    pitch=PitchConfig(threshold=0.2, fmin=60.0, fmax=600.0, refine="sinc", refine_depth=None),
    formant=FormantConfig(n_coeffs=13),
    mfcc=MfccConfig(num_coeffs=13),
)

#: bench.py's configuration (bench.py:45-56): 4096-sample frames (the
#: reference bench frame), hop 1024 at 44.1 kHz, MFCC over 100-8000 Hz. Its
#: power-of-two frames take kernel E.
BENCH_44K = AnalysisConfig(
    sample_rate=44100.0,
    frame_len=4096,
    hop=1024,
    pitch=PitchConfig(threshold=0.2, fmin=60.0, fmax=600.0, max_candidates=32),
    formant=FormantConfig(n_coeffs=13),
    mfcc=MfccConfig(num_coeffs=13, freq_lo=100.0, freq_hi=8000.0),
)

#: The flagship configuration (`__graft_entry__.FLAGSHIP`): 2048/512 at
#: 44.1 kHz, otherwise as BENCH_44K.
FLAGSHIP_44K = AnalysisConfig(
    sample_rate=44100.0,
    frame_len=2048,
    hop=512,
    pitch=PitchConfig(threshold=0.2, fmin=60.0, fmax=600.0, max_candidates=32),
    formant=FormantConfig(n_coeffs=13),
    mfcc=MfccConfig(num_coeffs=13, freq_lo=100.0, freq_hi=8000.0),
)


def config_from_jax(cfg) -> AnalysisConfig:
    """This module's AnalysisConfig with the values of a
    `voxtpu.pipeline.AnalysisConfig` (read by attribute)."""
    p, f, m = cfg.pitch, cfg.formant, cfg.mfcc
    return AnalysisConfig(
        sample_rate=float(cfg.sample_rate),
        frame_len=int(cfg.frame_len),
        hop=int(cfg.hop),
        pitch=PitchConfig(
            enabled=bool(p.enabled), threshold=float(p.threshold), fmin=float(p.fmin),
            fmax=float(p.fmax), max_candidates=int(p.max_candidates), viterbi=bool(p.viterbi),
            refine=str(p.refine), refine_depth=None if p.refine_depth is None else int(p.refine_depth),
        ),
        formant=FormantConfig(
            enabled=bool(f.enabled), n_coeffs=int(f.n_coeffs), resample_ratio=float(f.resample_ratio),
            estimates=tuple(float(e) for e in f.estimates),
            estimate_bandwidth=float(f.estimate_bandwidth), polish=bool(f.polish),
        ),
        mfcc=MfccConfig(
            enabled=bool(m.enabled), num_coeffs=int(m.num_coeffs), freq_lo=float(m.freq_lo),
            freq_hi=float(m.freq_hi),
            preemphasis_factor=None if m.preemphasis_factor is None else float(m.preemphasis_factor),
            exact=bool(m.exact),
        ),
    )


def f0_outputs(f0: torch.Tensor, strength: torch.Tensor) -> dict:
    """f0 / f0_strength / hnr_db from a chosen pitch track. HNR is
    10 log10(r / (1 - r)) of the strength r (Boersma 1993 eq. 4), -inf where
    f0 == 0 (unvoiced)."""
    s_best = torch.clamp(strength, 1e-6, 1.0 - 1e-6)
    hnr = 10.0 * torch.log10(s_best / (1.0 - s_best))
    return {
        "f0": f0,
        "f0_strength": strength,
        "hnr_db": torch.where(f0 > 0, hnr, -math.inf),
    }


def f0_outputs_host(f0: np.ndarray, strength: np.ndarray) -> dict:
    """NumPy twin of `f0_outputs` for host arrays."""
    s_best = np.clip(strength, 1e-6, 1.0 - 1e-6)
    hnr = (10.0 * np.log10(s_best / (1.0 - s_best))).astype(strength.dtype)
    return {
        "f0": f0,
        "f0_strength": strength,
        "hnr_db": np.where(f0 > 0, hnr, np.asarray(-np.inf, dtype=hnr.dtype)),
    }


def analyze_frames(
    frames: torch.Tensor,
    config: AnalysisConfig,
    formant_estimates: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_formant_candidates: bool = False,
) -> dict:
    """Analyze rectangular frames (F, n): returns the feature dict.

    formant_estimates: optional (freqs, bws) overriding the config's starting
    estimates (the carry of a chunked analysis).
    return_formant_candidates: skip the tracker and return the per-frame
    resonance buffers ("resonance_freqs"/"resonance_bws") instead of
    "formant_freqs"/"formant_bws".
    """
    sr = config.sample_rate
    n = frames.shape[-1]
    dt, dev = frames.dtype, frames.device
    out: dict = {}

    window = constant(hann, n, dtype=dt, device=dev)
    windowed = frames * window

    out["rms"] = waves.rms(frames)
    input_status = torch.where(
        torch.all(torch.isfinite(frames), dim=-1), 0, errors.NONFINITE_INPUT
    ).to(torch.int32)

    # Power-of-two frames with pitch and MFCC on (and no preemphasis) share
    # one transform, kernel E on the card: the 2n-point power spectrum's even
    # bins are the n-point ones.
    share_fft = (
        config.pitch.enabled
        and config.mfcc.enabled
        and config.mfcc.preemphasis_factor is None
        and (n & (n - 1)) == 0
    )
    shared_ac = shared_half_power = None
    if share_fft:
        shared_half_power, shared_ac = power_and_autocorrelate(windowed, n)

    if config.pitch.enabled:
        p = config.pitch
        freq, strength, valid = pitch_frames(
            windowed, sr, threshold=p.threshold, fmin=p.fmin, fmax=p.fmax,
            max_candidates=p.max_candidates, precomputed_ac=shared_ac,
            refine=p.refine, refine_depth=p.refine_depth,
        )
        out["pitch_candidates_freq"] = freq
        out["pitch_candidates_strength"] = strength
        out["pitch_candidates_valid"] = valid
        if p.viterbi:
            # Praat's silence-aware unvoiced strength takes the frame's local
            # peak over the recording's peak (the reference pitch()'s unused
            # local_peak/global_peak, periodic.rs:357).
            out.update(_path_outputs(out, config, _local_peak(frames)))
        else:
            out.update(f0_outputs(freq[..., 0], strength[..., 0]))

    if config.formant.enabled:
        f = config.formant
        if return_formant_candidates:
            rfreq, rbw, status = formant_candidates(
                frames, sr, f.n_coeffs, resample_ratio=f.resample_ratio, polish=f.polish,
            )
            out["resonance_freqs"] = rfreq
            out["resonance_bws"] = rbw
        else:
            est_f, est_b = formant_estimates if formant_estimates is not None else (f.estimates, None)
            freqs, bws, status = find_formants(
                frames, sr, f.n_coeffs, resample_ratio=f.resample_ratio,
                estimates=est_f, estimate_bandwidth=f.estimate_bandwidth,
                estimate_bws=est_b, polish=f.polish,
            )
            out["formant_freqs"] = freqs
            out["formant_bws"] = bws
        out["status"] = status | input_status
    else:
        out["status"] = input_status

    if config.mfcc.enabled:
        m = config.mfcc
        x = frames
        if m.preemphasis_factor is not None:
            x = waves.preemphasis(x, m.preemphasis_factor)
        out["mfcc"] = mfcc(
            x * window, m.num_coeffs, (m.freq_lo, m.freq_hi), sr, exact=m.exact,
            half_power=shared_half_power,
        )
    return out


def _local_peak(frames: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.abs(frames), dim=-1)


def _intensity(local_peak: torch.Tensor) -> torch.Tensor:
    """Each frame's peak over its recording's peak (the last axis)."""
    return local_peak / torch.clamp(torch.amax(local_peak, dim=-1, keepdim=True), min=1e-30)


def _without_viterbi(config: AnalysisConfig) -> AnalysisConfig:
    return dataclasses.replace(config, pitch=dataclasses.replace(config.pitch, viterbi=False))


def _path_outputs(out: dict, config: AnalysisConfig, local_peak: torch.Tensor) -> dict:
    """f0/f0_strength/hnr_db along the Viterbi path through out's candidates."""
    return f0_outputs(*pitch_path(
        out["pitch_candidates_freq"], out["pitch_candidates_strength"], out["pitch_candidates_valid"],
        PathConfig(ceiling=config.pitch.fmax), local_intensity=_intensity(local_peak),
    ))


def analyze(samples, config: AnalysisConfig, device=None) -> dict:
    """Frame a 1-D signal and analyze it. Runs on the card unless `samples`
    is a tensor elsewhere or device="cpu" (voxtpu_torch.device.as_input)."""
    x = as_input(samples, device)
    return analyze_frames(frame_signal(x, config.frame_len, config.hop), config)


def analyze_batch(frames, config: AnalysisConfig, device=None) -> dict:
    """Analyze B same-shape recordings, (B, F, n) frames.

    The frame-parallel stages run over the B * F frames as one batch; the
    formant tracker (kernel D, its carry reset per recording) and the path
    search (kernel F, each recording with its own intensity peak) run once
    each for all B. Row b equals `analyze_frames(frames[b], config)`.
    All-zero frames are exact padding: they give no pitch candidates and
    an all-None formant trajectory, never NaNs.
    """
    frames = as_input(frames, device)
    B, F, n = frames.shape
    do_formants = config.formant.enabled
    do_viterbi = config.pitch.enabled and config.pitch.viterbi
    inner = _without_viterbi(config) if do_viterbi else config

    out = analyze_frames(frames.reshape(-1, n), inner, return_formant_candidates=do_formants)
    out = {k: v.reshape((B, F) + v.shape[1:]) for k, v in out.items()}
    if do_formants:
        est_f = constant(np.asarray, config.formant.estimates, dtype=frames.dtype, device=frames.device)
        est_b = torch.full_like(est_f, config.formant.estimate_bandwidth)
        out["formant_freqs"], out["formant_bws"] = formant_tracker_batched(
            out.pop("resonance_freqs"), out.pop("resonance_bws"), est_f, est_b,
        )
    if do_viterbi:
        out.update(_path_outputs(out, config, _local_peak(frames)))
    return out


def analyze_batch_padded(samples, lengths, config: AnalysisConfig, device=None) -> dict:
    """`analyze_batch` over a (B, S) block of zero-padded signals with their
    true sample counts `lengths` (B,): the corpus-block entry point.

    Frames that reach past a recording's end hold its tail and pad zeros,
    not all zeros, so they would give pitch candidates and move that
    recording's path: they are zeroed. Row b, trimmed to the recording's
    frame count, equals `analyze` of it.
    """
    samples = as_input(samples, device)
    n, hop = config.frame_len, config.hop
    frames = frame_signal(samples, n, hop)  # (B, F, n)
    F = frames.shape[1]
    lengths = torch.as_tensor(lengths, device=frames.device).long()
    nf = torch.clamp((lengths - n) // hop + 1, min=0)
    mask = torch.arange(F, device=frames.device)[None, :] < nf[:, None]
    return analyze_batch(frames * mask[:, :, None].to(frames.dtype), config)


def _analyze_batch_padded_packed(samples, lengths, config: AnalysisConfig, device=None):
    """`analyze_batch_padded` with every feature packed frame-major into one
    (B, F, W) tensor in the samples' dtype, keys in sorted order: one buffer
    to copy to the host, whose rows past a block's true frame count can be
    sliced off before the copy. float64 round-trips exactly. Returns the
    buffer and its unpack manifest, the (key, shape, NumPy dtype) list of
    what `analyze_batch_padded` returned."""
    samples = as_input(samples, device)
    out = analyze_batch_padded(samples, lengths, config)
    B = samples.shape[0]
    F = next(iter(out.values())).shape[1]
    keys = sorted(out)
    flat = torch.cat([out[k].reshape(B, F, -1).to(samples.dtype) for k in keys], dim=2)
    return flat, [(k, tuple(out[k].shape), _NP_DTYPE[out[k].dtype]) for k in keys]


def _unpack_frames(flat: np.ndarray, manifest) -> dict:
    """Invert the frame-major (B, F, W) packing. flat may hold fewer frame
    rows than the manifest's F (rows trimmed before the copy): shapes follow
    flat."""
    out = {}
    B, F = flat.shape[0], flat.shape[1]
    col = 0
    for k, shape, dtype in manifest:
        w = int(np.prod(shape[2:], dtype=np.int64)) if len(shape) > 2 else 1
        v = flat[:, :, col : col + w].reshape((B, F) + shape[2:])
        col += w
        if dtype == np.bool_:
            v = v != 0
        elif np.issubdtype(dtype, np.integer):
            v = np.rint(v).astype(dtype)
        out[k] = v
    return out


def analyze_batch_padded_fetch(samples, lengths, config: AnalysisConfig, trim_to: int | None = None,
                               device=None) -> dict:
    """`analyze_batch_padded` as host NumPy arrays through one packed buffer
    and one device-to-host copy. trim_to: copy only the first trim_to frame
    rows (the block's true largest frame count, known on the host)."""
    flat, manifest = _analyze_batch_padded_packed(samples, lengths, config, device=device)
    if trim_to is not None and trim_to < flat.shape[1]:
        flat = flat[:, :trim_to, :]
    return _unpack_frames(flat.cpu().numpy(), manifest)


_NP_DTYPE = {torch.float32: np.dtype(np.float32), torch.float64: np.dtype(np.float64),
             torch.int32: np.dtype(np.int32), torch.bool: np.dtype(np.bool_)}


def analyze_long(samples, config: AnalysisConfig, chunk_frames: int = 4096, device=None) -> dict:
    """Chunked analysis of a long recording, equal to a one-shot `analyze`.

    A Python loop analyses `chunk_frames` frames at a time (the last chunk
    holds the rest): the McCandless carry threads from each chunk's last
    frame into the next chunk's starting estimates, so the tracked
    trajectory is the serial one. With `config.pitch.viterbi` the path search
    (and its whole-recording intensity peak) runs once at the end over all
    frames' candidates. Device memory for the frames is one chunk's.
    """
    x = as_input(samples, device)
    n, hop = config.frame_len, config.hop
    F = num_frames(x.shape[-1], n, hop)
    if F <= chunk_frames:
        return analyze(x, config)
    do_viterbi = config.pitch.enabled and config.pitch.viterbi
    inner = _without_viterbi(config) if do_viterbi else config

    est_f = torch.as_tensor(config.formant.estimates, dtype=x.dtype, device=x.device)
    est = (est_f, torch.full_like(est_f, config.formant.estimate_bandwidth))
    outs, peaks = [], []
    for start in range(0, F, chunk_frames):
        nf = min(chunk_frames, F - start)
        frames = frame_signal(x[start * hop : (start + nf - 1) * hop + n], n, hop)
        out = analyze_frames(frames, inner, formant_estimates=est)
        if config.formant.enabled:
            est = (out["formant_freqs"][-1], out["formant_bws"][-1])
        outs.append(out)
        peaks.append(_local_peak(frames))
    full = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    if do_viterbi:
        full.update(_path_outputs(full, config, torch.cat(peaks)))
    return full


class StreamAnalyzer:
    """Push-style streaming analysis with an exact formant carry.

    `feed(block)` takes a 1-D sample block of any size and returns the
    completed `chunk_frames`-frame feature chunks it unlocked (maybe none);
    `finish()` flushes the last partial chunk. Memory is one chunk of frames
    plus a `frame_len - hop` sample tail. The concatenated chunks equal the
    one-shot `analyze` of the concatenated input. Each chunk carries an
    internal `_stream_local_peak` key that `finalize_viterbi` consumes.

    `config.pitch.viterbi` is rejected: the path search needs the whole
    recording (stream with viterbi=False and call `finalize_viterbi` on the
    chunks). The samples live on `device` (voxtpu_torch.device.as_input):
    with device=None the first block decides, a tensor keeping its device
    and anything else going to the card.

    Two hooks replace the per-chunk analysis, for runtimes that pack the
    features into fewer device-to-host copies (voxtpu_torch.serve), as in
    voxtpu.pipeline.StreamAnalyzer; pass at most one:
    - step(frames, nf, est) -> (features, next_est): `frames` the
      (chunk_frames, n) frames on the device, rows from nf on zero, `nf` the
      real frame count, `est` the opaque carry (None first). The features
      must include `_stream_local_peak`.
    - step_samples(samples, nf, est) -> (features, next_est): the host
      sample buffer instead, a NumPy array zero-padded to
      (chunk_frames - 1) * hop + frame_len samples. The buffer then stays
      on the host (`device` is unused); the callee frames and must treat
      frame rows from nf on as absent (they overlap the real tail samples).
    A hook's features are trimmed to nf frames here.
    """

    def __init__(self, config: AnalysisConfig, chunk_frames: int = 512, step=None, step_samples=None,
                 device=None):
        if step is not None and step_samples is not None:
            raise ValueError("pass step or step_samples, not both")
        if config.pitch.enabled and config.pitch.viterbi:
            raise ValueError(
                "streaming analysis cannot run Viterbi (whole-recording DP); "
                "stream with viterbi=False and call finalize_viterbi(chunks, "
                "config) on the collected chunks at end of stream"
            )
        self.config = config
        self.chunk_frames = int(chunk_frames)
        self._hop, self._n = config.hop, config.frame_len
        self._chunk_samples = (self.chunk_frames - 1) * self._hop + self._n
        self._device = device
        self._step = step
        self._step_samples = step_samples
        self._est = None
        self._buf = None
        self.frames_done = 0

    def _emit_chunk(self, nf: int) -> dict:
        L = (nf - 1) * self._hop + self._n
        if self._step_samples is not None:
            pad = np.zeros((self._chunk_samples,), self._buf.dtype)
            pad[:L] = self._buf[:L]
            out, self._est = self._step_samples(pad, nf, self._est)
            out = {k: v[:nf] for k, v in out.items()}
        elif self._step is not None:
            frames = frame_signal(self._buf[:L], self._n, self._hop)
            frames = torch.nn.functional.pad(frames, (0, 0, 0, self.chunk_frames - nf))
            out, self._est = self._step(frames, nf, self._est)
            out = {k: v[:nf] for k, v in out.items()}
        else:
            frames = frame_signal(self._buf[:L], self._n, self._hop)
            out = analyze_frames(frames, self.config, formant_estimates=self._est)
            if self.config.formant.enabled:
                self._est = (out["formant_freqs"][-1], out["formant_bws"][-1])
            out["_stream_local_peak"] = _local_peak(frames)
        self._buf = self._buf[nf * self._hop :]  # keep the overlap tail
        self.frames_done += nf
        return out

    @property
    def buffered_samples(self) -> int:
        return 0 if self._buf is None else self._buf.shape[0]

    def feed(self, block) -> list:
        """Append a sample block; return the completed chunks it unlocked."""
        if self._step_samples is not None:
            block = np.asarray(block).ravel()
            cat = np.concatenate
        else:
            block = as_input(block, self._device).reshape(-1)
            self._device = block.device
            cat = torch.cat
        if block.shape[0]:
            self._buf = block if self._buf is None else cat([self._buf, block])
        chunks = []
        while self._buf is not None and self._buf.shape[0] >= self._chunk_samples:
            chunks.append(self._emit_chunk(self.chunk_frames))
        return chunks

    def finish(self) -> list:
        """Flush the final partial chunk (0 or 1 chunks)."""
        nf = 0 if self._buf is None else min(num_frames(self._buf.shape[0], self._n, self._hop), self.chunk_frames)
        return [self._emit_chunk(nf)] if nf else []


def analyze_stream(blocks, config: AnalysisConfig, chunk_frames: int = 512, device=None):
    """Streaming analysis: a generator of per-chunk feature dicts over an
    iterable of sample blocks (a thin pull-style wrapper of StreamAnalyzer)."""
    analyzer = StreamAnalyzer(config, chunk_frames, device=device)
    for blk in blocks:
        yield from analyzer.feed(blk)
    yield from analyzer.finish()


def finalize_viterbi(chunks, config: AnalysisConfig) -> dict:
    """End-of-stream Viterbi: concatenate `analyze_stream` chunks and run the
    whole-recording path search (DP + intensity peak), giving the f0 /
    f0_strength / hnr_db of one-shot `analyze` with viterbi=True."""
    chunks = list(chunks)
    full = {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}
    full.update(_path_outputs(full, config, full.pop("_stream_local_peak")))
    return full
