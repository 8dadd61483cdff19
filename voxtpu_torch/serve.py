"""`python -m voxtpu_torch serve`: the HTTP analysis daemon, on the card.

Port of voxtpu.serve, with its endpoints, query parameters, JSON and npz
layouts, error codes and messages, and /stats keys:

  POST /analyze?<params>   WAV bytes in -> JSON (default) or npz features
  POST /stream/open?rate=<Hz>&<params>   open a streaming session -> session id
  POST /stream/append?session=ID        raw PCM bytes in -> completed chunks
  POST /stream/close?session=ID         flush the tail (+ whole-stream Viterbi)
  POST /stream/abort?session=ID         drop a session
  GET  /healthz            liveness + backend/device inventory
  GET  /stats              request/batch/latency counters

Request params (all optional; defaults come from the server's CLI flags):
  frame_ms, hop_ms, fmin, fmax, threshold, n_coeffs, mfcc_coeffs,
  features=pitch,formants,mfcc,rms, pitch_refine=sinc|parabolic,
  refine_depth=N, viterbi=0|1, channel=N|mix, format=json|npz

- **Micro-batching.** Concurrent /analyze requests with the same
  (config, padded frame count) gather for `window_ms` and run as one
  dispatch: one dispatcher thread stacks their raw samples into one
  (B, S) block in pinned host memory, copies it to the card without
  waiting, runs `pipeline._analyze_batch_padded_packed` (framing, the
  per-recording length mask and every feature, packed into one buffer),
  and starts the copy of the rows that exist back into pinned memory
  behind a CUDA event. It waits on that event only when it drains the
  batch, so with `pipeline_depth` 1 the next batch's host work overlaps
  this batch's device work. The frame axis lands on the bucket ladder
  (`cli._bucket_target`), the batch axis on powers of two up to
  `max_batch`.
- **Data parallelism.** With `data_parallel` N > 1 each batch of at least N
  recordings splits into N equal row blocks on the "files" axis, one block
  a card (`dispatch_split`): each block's copy in, launches and copy back
  run on its own card's current stream behind its own CUDA event, and the
  drain waits on every card's event; /stats' `device_time_s` sums them.
  Smaller batches stay on the first card, as in voxtpu. One host thread
  queues every block, so today a split batch takes longer than one
  dispatch (PERF.md §2).
- **No compiled programs.** voxtpu keeps an LRU of XLA executables, one a
  (config, shape); eager PyTorch compiles nothing per shape, so there is
  none. The kernels build once a checkout (`ops.kernels`); `warmup()` builds
  them and runs each warm shape once.
- **Streaming sessions** take raw PCM in appends of any size and run each
  `chunk_frames` chunk as it completes (`pipeline.StreamAnalyzer`'s
  `step_samples` hook: one copy to the card, the chunk's real frames, one
  packed copy back), the formant carry staying on the card between appends.
- **Viterbi** runs on the server's device (kernel F on the card) over each
  recording's trimmed candidates, per /analyze request and at stream close;
  voxtpu runs it on the host because its device DP compiles a program per
  recording length.

All device work runs on the device's current stream: the dispatcher's and
the stream handlers' launches interleave there. The server runs on the card
unless `ServeConfig.device` says "cpu"; without a card it raises
`NoCudaDevice`. Streams and the Viterbi run on `device`; batches on the
first `data_parallel` of `device`'s distinct cards (`dist.local_devices`),
the server's own card first.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import traceback
import urllib.parse
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from voxtpu_torch.cli import _bucket_target, build_analysis_config
from voxtpu_torch.device import resolve_device
from voxtpu_torch.dist import local_devices
from voxtpu_torch.frame import frame_signal
from voxtpu_torch.io_wav import read_wav_bytes
from voxtpu_torch.pipeline import (
    _NP_DTYPE, StreamAnalyzer, _analyze_batch_padded_packed, _intensity, _local_peak, _unpack_frames,
    analyze_frames, f0_outputs,
)
from voxtpu_torch.viterbi import PathConfig, pitch_path

__all__ = ["ServeConfig", "VoxServer", "dispatch_split"]


@dataclass(frozen=True)
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    #: micro-batch gather window after the first request of a batch arrives
    window_ms: float = 3.0
    #: max files per device dispatch (batch axis pads to powers of two <= this)
    max_batch: int = 8
    #: frame bucket (0 disables padding: every length is its own shape)
    bucket: int = 1024
    #: cards on the "files" axis (power of two): each batch of at least this
    #: many recordings splits over them
    data_parallel: int = 1
    max_body_bytes: int = 256 << 20
    #: how long a request may wait on the device queue
    request_timeout_s: float = 900.0
    #: dispatched-but-undrained batches allowed in flight while the next
    #: batch dispatches (1 = double-buffered, 0 = drain each batch first)
    pipeline_depth: int = 1
    #: when False, requests may not override analysis params; host-side
    #: params (channel, format, viterbi) stay available. Pin
    #: `allowed_rates` too: the WAV header's rate sets the frame length.
    allow_param_overrides: bool = True
    #: sample rates (Hz) accepted from request WAV headers; empty = any
    allowed_rates: tuple = ()
    #: frames per streaming-session chunk; clients may override at
    #: /stream/open unless param overrides are locked
    stream_chunk_frames: int = 512
    #: concurrent streaming sessions
    max_streams: int = 64
    #: streaming sessions idle longer than this are garbage-collected
    stream_idle_timeout_s: float = 600.0
    #: analysis defaults applied to requests that don't override them
    defaults: dict = field(default_factory=dict)
    #: torch device the server runs on; None = the CUDA card
    #: (`device.resolve_device`: without one the server raises)
    device: str | None = None


_ALLOWED_PARAMS = {
    "frame_ms", "hop_ms", "fmin", "fmax", "threshold", "n_coeffs",
    "mfcc_coeffs", "features", "pitch_refine", "refine_depth", "viterbi",
    "channel", "format",
}
_FLOAT_PARAMS = {"frame_ms", "hop_ms", "fmin", "fmax", "threshold"}
_INT_PARAMS = {"n_coeffs", "mfcc_coeffs", "refine_depth"}


class RequestError(ValueError):
    """Client error -> HTTP 400."""


class _Pending:
    __slots__ = ("samples", "F", "event", "result", "error")

    def __init__(self, samples: np.ndarray, F: int):
        # (L,) float32 raw samples, L = (F-1)*hop + frame_len exactly: the
        # dispatcher stacks samples and frames them on the device.
        self.samples = samples
        self.F = F
        self.event = threading.Event()
        self.result = None
        self.error = None


_STOP = object()


def _pow2_batch(b: int, max_batch: int) -> int:
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch)


def _samples_for_frames(config, Fp: int) -> int:
    """Sample count whose framing yields exactly Fp frames."""
    return (Fp - 1) * config.hop + config.frame_len


class _DeviceTimer:
    """Seconds of device work from construction to `stop()`: CUDA events on
    the queue of the card, so `seconds()` waits for the work and counts no
    host time; on the CPU, whose work is done when it returns, the host
    clock from construction to `stop()`."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = self.t1 = time.monotonic()

    def stop(self) -> None:
        if self.stream is not None:
            self.end.record(self.stream)
        self.t1 = time.monotonic()

    def seconds(self) -> float:
        """Waits for the timed work to finish."""
        if self.stream is None:
            return self.t1 - self.t0
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def dispatch_split(stack: torch.Tensor, lengths: torch.Tensor, config, devices: list, rows: int):
    """Launch one packed batch split over `devices` on the "files" axis,
    waiting for none of them.

    stack (B, S) raw samples and lengths (B,) lie on the host (pinned, for
    cards). B splits into len(devices) equal row blocks (a B they do not
    divide raises ValueError); block i runs
    `pipeline._analyze_batch_padded_packed` on devices[i], and its first
    `rows` frame rows are copied into its rows of one host buffer (pinned
    for cards): the copy in, the launches and the copy back on that device's
    current stream. Returns (out (B, rows, W), manifest, timers), one
    `_DeviceTimer` a block: `out` is complete once every timer's `seconds()`
    has returned."""
    B = stack.shape[0]
    if B % len(devices):
        raise ValueError(f"batch {B} not divisible by {len(devices)} devices")
    per = B // len(devices)
    out, timers = None, []
    for i, dev in enumerate(devices):
        block = slice(i * per, (i + 1) * per)
        timer = _DeviceTimer(dev)
        flat, manifest = _analyze_batch_padded_packed(
            stack[block].to(dev, non_blocking=True), lengths[block].to(dev, non_blocking=True), config
        )
        flat = flat[:, :rows]
        if out is None:
            out = torch.empty((B,) + tuple(flat.shape[1:]), dtype=flat.dtype, pin_memory=dev.type == "cuda")
        out[block].copy_(flat, non_blocking=True)
        timer.stop()
        timers.append(timer)
    return out, manifest, timers


class _MicroBatcher:
    """Single dispatcher thread owning the batch work: drains the request
    queue, groups same-(config, Fp) items inside the gather window, and runs
    each group as one `_analyze_batch_padded_packed` dispatch."""

    def __init__(self, cfg: ServeConfig, stats: "_Stats", devices: list):
        self.cfg = cfg
        self.stats = stats
        self.devices = devices
        self.q: queue.Queue = queue.Queue()
        self._stopping = False
        self.thread = threading.Thread(target=self._loop, daemon=True, name="voxtpu-batcher")
        self.thread.start()

    def submit(self, key, item: _Pending) -> None:
        if self._stopping:
            # Fail fast: a submit landing after stop()'s final drain would
            # otherwise block its waiter the full request_timeout_s.
            item.error = "server shutting down"
            item.event.set()
            return
        self.q.put((key, item))
        if self._stopping:
            # stop() may have set the flag and drained between our check and
            # our put; drain again so THIS item can't be stranded.
            self._drain_shutdown()

    def stop(self) -> None:
        self._stopping = True
        self.q.put(_STOP)
        self.thread.join(timeout=10.0)
        # Whatever still sits in the queue (items enqueued behind the
        # sentinel by in-flight handler threads) must error out now.
        self._drain_shutdown()

    def _drain_shutdown(self) -> None:
        while True:
            try:
                nxt = self.q.get_nowait()
            except queue.Empty:
                return
            if nxt is _STOP:
                continue
            _k, it = nxt
            it.error = "server shutting down"
            it.event.set()

    def _loop(self) -> None:
        # `inflight` holds dispatched-but-undrained batches: while the device
        # computes batch k, the dispatcher may stack and dispatch batch k+1
        # (pipeline_depth > 0). Whenever the queue goes quiet, everything in
        # flight drains at once: idle traffic never waits.
        inflight: list = []
        depth = max(0, int(self.cfg.pipeline_depth))
        while True:
            if inflight:
                try:
                    head = self.q.get_nowait()
                except queue.Empty:
                    for p in inflight:
                        self._drain(p)
                    inflight = []
                    continue
            else:
                head = self.q.get()
            if head is _STOP:
                for p in inflight:
                    self._drain(p)
                self._drain_shutdown()
                return
            groups: dict = {}
            key, item = head
            groups[key] = [item]
            deadline = time.monotonic() + self.cfg.window_ms / 1e3
            stop = False
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                k, it = nxt
                groups.setdefault(k, []).append(it)
                if all(len(v) >= self.cfg.max_batch for v in groups.values()):
                    break
            for k, items in groups.items():
                for i in range(0, len(items), self.cfg.max_batch):
                    p = self._dispatch(k, items[i : i + self.cfg.max_batch])
                    if p is not None:
                        inflight.append(p)
                    while len(inflight) > depth:
                        self._drain(inflight.pop(0))
            if stop:
                for p in inflight:
                    self._drain(p)
                return

    def _dispatch(self, key, items: list):
        """Stack and launch one batch without waiting for the device;
        returns the in-flight record (None if the dispatch itself failed:
        its waiters already hold the error)."""
        config, Fp, _n = key
        try:
            B = _pow2_batch(len(items), self.cfg.max_batch)
            # Smaller batches stay on the first card: a split would pad a lone
            # request to data_parallel recordings (voxtpu/serve.py:547-551).
            devices = self.devices if B >= len(self.devices) else self.devices[:1]
            pin = devices[0].type == "cuda"
            # Raw samples, framed on the device: each request's samples span
            # exactly its F frames, so the length mask marks the frames that
            # exist. Only the tails are zeroed.
            S = _samples_for_frames(config, Fp)
            stack = torch.empty((B, S), dtype=torch.float32, pin_memory=pin)
            lengths = torch.zeros((B,), dtype=torch.int64, pin_memory=pin)
            host, host_len = stack.numpy(), lengths.numpy()
            for i, it in enumerate(items):
                L = it.samples.shape[0]
                host[i, :L] = it.samples
                host[i, L:] = 0.0
                host_len[i] = L
            host[len(items) :] = 0.0
            # Rung-padding rows are cut before the copy, quantized to 64-frame
            # steps (voxtpu/serve.py:566-573).
            Fmaxb = min(Fp, max(64, (max(it.F for it in items) + 63) // 64 * 64))
            out, manifest, timers = dispatch_split(stack, lengths, config, devices, Fmaxb)
            # The host buffers stay referenced until the batch drains.
            return (key, items, B, out, manifest, timers, stack, lengths)
        except Exception:  # surface device failures to every waiter
            err = traceback.format_exc()
            for it in items:
                it.error = err
                it.event.set()
            return None

    def _drain(self, pending) -> None:
        """Wait for one in-flight batch, unpack it and release its waiters."""
        key, items, B, out, manifest, timers = pending[:6]
        try:
            dt = sum(t.seconds() for t in timers)  # waits for every card's copy back
            self.stats.record_batch(len(items), B, dt, key)
            feats = _unpack_frames(out.numpy(), manifest)
            for i, it in enumerate(items):
                it.result = {k: v[i, : it.F] for k, v in feats.items()}
                it.event.set()
        except Exception:
            err = traceback.format_exc()
            for it in items:
                it.error = err
                it.event.set()


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.batched_requests = 0
        self.batch_size_hist: dict = {}
        self.shapes: set = set()
        self.latencies: list = []  # rolling, seconds (end-to-end per request)
        self.device_s = 0.0
        self.stream_sessions = 0
        self.stream_chunks = 0
        self.stream_frames = 0
        self.started = time.time()

    def record_request(self, latency_s: float, ok: bool) -> None:
        with self.lock:
            self.requests += 1
            if not ok:
                self.errors += 1
            self.latencies.append(latency_s)
            if len(self.latencies) > 1000:
                self.latencies = self.latencies[-1000:]

    def record_batch(self, n_items: int, B: int, device_s: float, key) -> None:
        config, Fp, n = key
        with self.lock:
            self.batches += 1
            self.batched_requests += n_items
            self.batch_size_hist[n_items] = self.batch_size_hist.get(n_items, 0) + 1
            self.shapes.add((B, Fp, n))
            self.device_s += device_s

    def record_stream_chunk(self, nf: int, device_s: float, shape) -> None:
        with self.lock:
            self.stream_chunks += 1
            self.stream_frames += nf
            self.shapes.add(shape)
            self.device_s += device_s

    def record_stream_session(self) -> None:
        with self.lock:
            self.stream_sessions += 1

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies)

            def pct(p):
                return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2) if lat else None

            return {
                "uptime_s": round(time.time() - self.started, 1),
                "requests": self.requests,
                "errors": self.errors,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "batch_size_hist": {str(k): v for k, v in sorted(self.batch_size_hist.items())},
                # Shapes served (voxtpu's name: one compiled program each there).
                "compiled_shapes": sorted(list(self.shapes)),
                "latency_ms": {"p50": pct(0.50), "p95": pct(0.95), "max": pct(1.0)},
                "device_time_s": round(self.device_s, 3),
                "stream_sessions": self.stream_sessions,
                "stream_chunks": self.stream_chunks,
                "stream_frames": self.stream_frames,
            }


def _viterbi(result: dict, local_peak: np.ndarray, fmax: float, device: torch.device) -> dict:
    """Whole-recording Viterbi path search over a recording's trimmed
    candidates and its frames' peaks, on `device` (kernel F on the card);
    returns the f0 / f0_strength / hnr_db update as host arrays."""

    def dev(key):
        return torch.as_tensor(result[key], device=device)

    f0, s0 = pitch_path(
        dev("pitch_candidates_freq"), dev("pitch_candidates_strength"), dev("pitch_candidates_valid"),
        PathConfig(ceiling=fmax), local_intensity=_intensity(torch.as_tensor(local_peak, device=device)),
    )
    return {k: v.cpu().numpy() for k, v in f0_outputs(f0, s0).items()}


_STREAM_PARAMS = {"rate", "encoding", "channels", "chunk_frames"}
_STREAM_ENCODINGS = ("f32le", "s16le")


class _StreamSession:
    """One `/stream/*` session: byte-level PCM reassembly and channel
    selection in front of a `pipeline.StreamAnalyzer` whose `step_samples`
    hook runs each chunk on the server's device.

    Appends may split samples and frames anywhere: a partial-sample byte
    tail and the analyzer's `frame_len - hop` sample tail carry across
    appends, so server memory stays bounded whatever the stream's length.
    The formant carry stays on the device between appends. Viterbi sessions
    also keep each chunk's trimmed pitch candidates and frame peaks (the
    whole-recording path search needs them) and run the search at close."""

    _DTYPES = {"f32le": np.dtype("<f4"), "s16le": np.dtype("<i2")}

    def __init__(self, sid: str, config, p: dict, stats: _Stats, chunk_frames: int, device: torch.device):
        self.sid = sid
        self.config = config
        self.stats = stats
        self.device = device
        self.lock = threading.Lock()
        self.last_used = time.monotonic()
        self.encoding = p.get("encoding", "f32le")
        self.dtype = self._DTYPES[self.encoding]
        self.channels = int(p.get("channels", 1))
        self.channel = str(p.get("channel", "0"))
        self.fmt = p.get("format", "json")
        self.byte_tail = b""
        self.closed = False
        self.viterbi = bool(p.get("viterbi")) and config.pitch.enabled
        self._vit_acc: list = []
        self.analyzer = StreamAnalyzer(config, chunk_frames, step_samples=self._packed_step)

    def _packed_step(self, samples: np.ndarray, nf: int, est):
        """One chunk: one copy of its samples to the device, its nf real
        frames analyzed with the carried estimates, one packed copy back.
        The frames are those `pipeline.analyze_long` takes for the chunk."""
        cfg = self.config
        n, hop = cfg.frame_len, cfg.hop
        if est is None:
            est_f = torch.as_tensor(cfg.formant.estimates, dtype=torch.float32, device=self.device)
            est = (est_f, torch.full_like(est_f, cfg.formant.estimate_bandwidth))
        timer = _DeviceTimer(self.device)
        frames = frame_signal(torch.as_tensor(samples[: (nf - 1) * hop + n], device=self.device), n, hop)
        out = analyze_frames(frames, cfg, formant_estimates=est)
        out["_stream_local_peak"] = _local_peak(frames)
        if cfg.formant.enabled:
            est = (out["formant_freqs"][-1], out["formant_bws"][-1])
        keys = sorted(out)
        flat = torch.cat([out[k].reshape(nf, -1).to(torch.float32) for k in keys], dim=1).cpu()
        timer.stop()
        self.stats.record_stream_chunk(nf, timer.seconds(), (1, self.analyzer.chunk_frames, n))
        manifest = [(k, (1,) + tuple(out[k].shape), _NP_DTYPE[out[k].dtype]) for k in keys]
        return {k: v[0] for k, v in _unpack_frames(flat.numpy()[None], manifest).items()}, est

    def _decode(self, body: bytes) -> np.ndarray:
        data = self.byte_tail + body
        unit = self.dtype.itemsize * self.channels
        keep = len(data) // unit * unit
        self.byte_tail = data[keep:]
        x = np.frombuffer(data[:keep], dtype=self.dtype)
        if self.dtype.kind == "i":
            # The reference's integer normalization at 16 valid bits:
            # s / (i32::MAX >> 16) == s / 32767 (tests/lib.rs:17-19).
            x = x.astype(np.float32) / 32767.0
        else:
            x = x.astype(np.float32)
        if self.channels > 1:
            x = x.reshape(-1, self.channels)
            mono, _note = _select_channel(x, self.channel)
            return np.ascontiguousarray(mono, dtype=np.float32)
        return x

    def _collect(self, chunks: list) -> tuple[int, dict]:
        """Accumulate viterbi state; concatenate the client-visible features."""
        if self.viterbi:
            for c in chunks:
                self._vit_acc.append({
                    "freq": c["pitch_candidates_freq"],
                    "strength": c["pitch_candidates_strength"],
                    "valid": c["pitch_candidates_valid"],
                    "peak": c["_stream_local_peak"],
                })
        feats: dict = {}
        nf = 0
        if chunks:
            keys = [k for k in chunks[0] if not k.startswith("_")]
            feats = {k: np.concatenate([c[k] for c in chunks]) for k in keys}
            nf = int(sum(c["_stream_local_peak"].shape[0] for c in chunks))
        return nf, feats

    def append(self, body: bytes) -> tuple[int, dict]:
        self.last_used = time.monotonic()
        return self._collect(self.analyzer.feed(self._decode(body)))

    def close(self, body: bytes) -> tuple[int, dict, dict | None]:
        """Flush the tail chunk; run the end-of-stream Viterbi if requested.
        Returns (tail_frames, tail_features, viterbi_features_or_None) where
        the viterbi features span the whole stream (frames_done long)."""
        chunks = self.analyzer.feed(self._decode(body)) if body else []
        chunks += self.analyzer.finish()
        nf, feats = self._collect(chunks)
        vit = None
        if self.viterbi:
            vit = {}
            if self._vit_acc:
                full = {
                    "pitch_candidates_freq": np.concatenate([a["freq"] for a in self._vit_acc]),
                    "pitch_candidates_strength": np.concatenate([a["strength"] for a in self._vit_acc]),
                    "pitch_candidates_valid": np.concatenate([a["valid"] for a in self._vit_acc]),
                }
                peak = np.concatenate([a["peak"] for a in self._vit_acc])
                vit = _viterbi(full, peak, self.config.pitch.fmax, self.device)
        self.closed = True
        return nf, feats, vit


def _frame_host(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    """Host-side framing, identical to frame.frame_signal's strided
    semantics: F = (n - frame_len)//hop + 1 windows at stride hop."""
    if x.shape[0] < frame_len:
        raise RequestError(
            f"audio shorter than one frame ({x.shape[0]} < {frame_len} samples)"
        )
    win = np.lib.stride_tricks.sliding_window_view(x, frame_len)[::hop]
    return np.ascontiguousarray(win, dtype=np.float32)


def _select_channel(samples: np.ndarray, channel: str):
    """Mirror cli._read's channel semantics on decoded samples; returns
    (mono_samples, note_or_None)."""
    mix = str(channel).strip().lower() == "mix"
    if not mix:
        try:
            idx = int(channel)
        except ValueError:
            raise RequestError(f"bad channel: {channel!r}")
        if idx < 0:
            # A negative index would select from the end by NumPy's rules.
            raise RequestError(f"channel must be non-negative, got {idx}")
    if samples.ndim == 1:
        if not mix and idx > 0:
            raise RequestError(f"channel {channel} out of range: input has 1 channel")
        return samples, None
    n_ch = samples.shape[1]
    if mix:
        return samples.mean(axis=1, dtype=samples.dtype), f"{n_ch}-channel input, mixed down"
    if idx >= n_ch:
        raise RequestError(f"channel {idx} out of range: input has {n_ch} channel(s)")
    return samples[:, idx], f"{n_ch}-channel input, using channel {idx}"


def _jsonable(v: np.ndarray):
    """Strict-JSON feature encoding: bools as 0/1, non-finite floats as null
    (hnr_db is -inf on unvoiced frames; `format=npz` keeps them exact)."""
    if v.dtype == bool:
        return v.astype(np.uint8).tolist()
    if np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
        obj = v.astype(object)
        obj[~np.isfinite(v)] = None
        return obj.tolist()
    return v.tolist()


class VoxServer:
    """The serving runtime: HTTP front end + micro-batching dispatcher.

    Use `start()`/`shutdown()` for embedding (tests), `serve_forever()` from
    the CLI."""

    def __init__(self, cfg: ServeConfig):
        dp = cfg.data_parallel
        if dp < 1 or (dp & (dp - 1)):
            raise ValueError(f"data_parallel must be a power of two, got {dp}")
        if cfg.max_batch < dp or cfg.max_batch % dp:
            raise ValueError(
                f"max_batch ({cfg.max_batch}) must be a multiple of "
                f"data_parallel ({dp})"
            )
        self.device = resolve_device(cfg.device)  # NoCudaDevice without a card
        devices = local_devices(self.device)
        if self.device in devices:  # the server's own card leads
            devices.remove(self.device)
            devices.insert(0, self.device)
        if dp > len(devices):
            raise ValueError(f"data_parallel {dp} > {len(devices)} devices")
        self.devices = devices[:dp]
        self.cfg = cfg
        self.stats = _Stats()
        self.batcher = _MicroBatcher(cfg, self.stats, self.devices)
        self._streams: dict = {}
        self._streams_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Serving logs go through the stats endpoint, not stderr spam.
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def do_GET(self):  # noqa: N802
                path = urllib.parse.urlparse(self.path).path
                if path == "/healthz":
                    self._json(200, server.health())
                elif path == "/stats":
                    self._json(200, server.stats.snapshot())
                else:
                    self._json(404, {"error": f"unknown path {path}"})

            _POST_ROUTES = (
                "/analyze", "/stream/open", "/stream/append", "/stream/close",
                "/stream/abort",
            )

            def do_POST(self):  # noqa: N802
                t0 = time.monotonic()
                parsed = urllib.parse.urlparse(self.path)
                path = parsed.path
                if path not in self._POST_ROUTES:
                    self._json(404, {"error": f"unknown path {path}"})
                    return
                ok = False
                try:
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    if length > server.cfg.max_body_bytes:
                        raise RequestError(
                            f"body too large ({length} > {server.cfg.max_body_bytes}"
                            "); for long recordings use /stream/open + append"
                        )
                    body = self.rfile.read(length) if length > 0 else b""
                    if path == "/analyze":
                        if not body:
                            raise RequestError("empty body (expected WAV bytes)")
                        self._emit(*server.analyze_request(body, parsed.query))
                    elif path == "/stream/open":
                        self._json(200, server.stream_open(parsed.query))
                    elif path == "/stream/append":
                        if not body:
                            raise RequestError("empty body (expected raw PCM bytes)")
                        self._emit(*server.stream_append(parsed.query, body))
                    elif path == "/stream/close":
                        self._emit(*server.stream_close(parsed.query, body))
                    else:  # /stream/abort
                        self._json(200, server.stream_abort(parsed.query))
                    ok = True
                except RequestError as e:
                    self._json(400, {"error": str(e)})
                except TimeoutError as e:
                    self._json(503, {"error": str(e)})
                except Exception:
                    self._json(500, {"error": traceback.format_exc(limit=20)})
                finally:
                    server.stats.record_request(time.monotonic() - t0, ok)

            def _emit(self, fmt, payload):
                if fmt == "npz":
                    self._bytes(200, payload, "application/octet-stream")
                else:
                    self._json(200, payload)

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self._bytes(code, data, "application/json")

            def _bytes(self, code, data, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        # http.server's default accept backlog is 5: a 16-connection burst
        # overflows it and clients see ConnectionResetError before the
        # request is even read. Size it to the traffic the batcher is built for.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        try:
            self.httpd = _Server((cfg.host, cfg.port), Handler)
        except OSError:
            self.batcher.stop()
            raise
        self.httpd.daemon_threads = True

    # ---- request pipeline -------------------------------------------------

    def _params(self, query: str) -> dict:
        raw = urllib.parse.parse_qs(query, keep_blank_values=True)
        unknown = set(raw) - _ALLOWED_PARAMS
        if unknown:
            raise RequestError(
                f"unknown parameter(s): {sorted(unknown)}; allowed: {sorted(_ALLOWED_PARAMS)}"
            )
        if not self.cfg.allow_param_overrides:
            locked = set(raw) - {"channel", "format", "viterbi"}
            if locked:
                raise RequestError(
                    f"analysis parameter overrides are disabled on this "
                    f"server (got {sorted(locked)}); only channel/format/"
                    f"viterbi are accepted"
                )
        p = dict(self.cfg.defaults)
        for k, vs in raw.items():
            v = vs[-1]
            try:
                if k in _FLOAT_PARAMS:
                    p[k] = float(v)
                elif k in _INT_PARAMS:
                    p[k] = int(v)
                elif k == "viterbi":
                    p[k] = v.lower() in ("1", "true", "yes", "on")
                else:
                    p[k] = v
            except ValueError:
                raise RequestError(f"bad value for {k}: {v!r}")
        # Semantic validation: every client-controlled value that would
        # otherwise blow up deep inside framing/config as a 500.
        if p.get("frame_ms", 50.0) <= 0 or p.get("hop_ms", 10.0) <= 0:
            raise RequestError("frame_ms and hop_ms must be > 0")
        if p.get("fmin", 60.0) <= 0 or p.get("fmax", 600.0) <= p.get("fmin", 60.0):
            raise RequestError("need 0 < fmin < fmax")
        if p.get("n_coeffs", 13) < 1 or p.get("mfcc_coeffs", 13) < 1:
            raise RequestError("n_coeffs and mfcc_coeffs must be >= 1")
        if p.get("refine_depth") is not None and p["refine_depth"] < 1:
            raise RequestError("refine_depth must be >= 1")
        if p.get("pitch_refine", "sinc") not in ("sinc", "parabolic"):
            raise RequestError("pitch_refine must be 'sinc' or 'parabolic'")
        ch = str(p.get("channel", "0")).strip().lower()
        if ch != "mix" and not ch.isdigit():
            raise RequestError("channel must be a non-negative integer or 'mix'")
        if p.get("format", "json") not in ("json", "npz"):
            raise RequestError("format must be 'json' or 'npz'")
        return p

    def _config(self, sample_rate: float, p: dict):
        """The analysis config of a request. Viterbi is not part of it: the
        whole-recording path search runs per request on the trimmed
        candidates (`_viterbi`); in the padded batch its backtrace would
        start in the zero-padded tail."""
        if self.cfg.allowed_rates and sample_rate not in self.cfg.allowed_rates:
            raise RequestError(
                f"sample rate {sample_rate:g} Hz not served; allowed: "
                f"{sorted(self.cfg.allowed_rates)}"
            )
        try:
            return build_analysis_config(
                sample_rate,
                frame_ms=p.get("frame_ms", 50.0),
                hop_ms=p.get("hop_ms", 10.0),
                features=p.get("features", "pitch,formants,mfcc,rms"),
                fmin=p.get("fmin", 60.0),
                fmax=p.get("fmax", 600.0),
                threshold=p.get("threshold", 0.2),
                n_coeffs=p.get("n_coeffs", 13),
                mfcc_coeffs=p.get("mfcc_coeffs", 13),
                pitch_refine=p.get("pitch_refine", "sinc"),
                refine_depth=p.get("refine_depth"),
            )
        except ValueError as e:
            # e.g. an unknown feature name: a client error, not a 500.
            raise RequestError(str(e))

    def analyze_request(self, body: bytes, query: str):
        """Decode, queue and wait for one request; returns (format, payload)."""
        p = self._params(query)
        try:
            wav = read_wav_bytes(body, dtype=np.float32)
        except Exception as e:
            raise RequestError(f"cannot decode WAV body: {e}")
        samples, note = _select_channel(wav.samples, p.get("channel", "0"))
        config = self._config(float(wav.sample_rate), p)

        if samples.shape[0] < config.frame_len:
            raise RequestError(
                f"audio shorter than one frame "
                f"({samples.shape[0]} < {config.frame_len} samples)"
            )
        F = (samples.shape[0] - config.frame_len) // config.hop + 1
        Fp = _bucket_target(F, self.cfg.bucket)
        # Trim the tail past the last frame's window (no frame reads it); the
        # dispatcher zero-pads rows to the rung's S.
        L = (F - 1) * config.hop + config.frame_len
        samples = np.ascontiguousarray(samples[:L], dtype=np.float32)

        item = _Pending(samples, F)
        self.batcher.submit((config, Fp, config.frame_len), item)
        if not item.event.wait(self.cfg.request_timeout_s):
            raise TimeoutError(
                f"analysis timed out after {self.cfg.request_timeout_s}s "
                "(retry or raise the timeout)"
            )
        if item.error is not None:
            raise RuntimeError(item.error)

        if p.get("viterbi") and config.pitch.enabled:
            # The path search over the trimmed candidates (see _config).
            frames_h = _frame_host(samples, config.frame_len, config.hop)
            lp = np.max(np.abs(frames_h[:F]), axis=-1)
            item.result.update(_viterbi(item.result, lp, config.pitch.fmax, self.device))

        meta = {
            "frames": F,
            "sample_rate": float(wav.sample_rate),
            "frame_len": config.frame_len,
            "hop": config.hop,
        }
        if note:
            meta["note"] = note
        if p.get("format", "json") == "npz":
            buf = io.BytesIO()
            np.savez(buf, **item.result)
            return "npz", buf.getvalue()
        return "json", {**meta, "features": {k: _jsonable(v) for k, v in item.result.items()}}

    # ---- streaming sessions -------------------------------------------------
    # Long recordings cannot ride /analyze (whole-body upload, max_body_bytes
    # cap): /stream/open declares the wire format, /stream/append pushes raw
    # PCM in bodies of any size, /stream/close flushes the tail and runs the
    # end-of-stream Viterbi. Bounded server memory at any length. A session's
    # device work runs on its handler thread under the session lock.

    def _stream_session_params(self, query: str) -> tuple[dict, dict]:
        """Split /stream/open's query into (analysis params via _params,
        validated stream wire params)."""
        raw = urllib.parse.parse_qs(query, keep_blank_values=True)
        sp = {k: raw.pop(k)[-1] for k in list(raw) if k in _STREAM_PARAMS}
        if not self.cfg.allow_param_overrides and "chunk_frames" in sp:
            raise RequestError(
                "chunk_frames overrides are disabled on this server (the "
                "server's flags set the chunk shape)"
            )
        p = self._params(urllib.parse.urlencode(
            [(k, v) for k, vs in raw.items() for v in vs]
        ))
        out: dict = {}
        try:
            out["rate"] = float(sp["rate"]) if "rate" in sp else 0.0
        except ValueError:
            raise RequestError(f"bad value for rate: {sp['rate']!r}")
        if out["rate"] <= 0:
            raise RequestError("stream open requires rate=<Hz> (> 0); raw PCM "
                               "bodies carry no WAV header to read it from")
        out["encoding"] = sp.get("encoding", "f32le")
        if out["encoding"] not in _STREAM_ENCODINGS:
            raise RequestError(
                f"encoding must be one of {_STREAM_ENCODINGS}, got {out['encoding']!r}"
            )
        try:
            out["channels"] = int(sp.get("channels", 1))
            out["chunk_frames"] = int(sp.get("chunk_frames", self.cfg.stream_chunk_frames))
        except ValueError:
            raise RequestError("channels and chunk_frames must be integers")
        if not 1 <= out["channels"] <= 64:
            raise RequestError(f"channels must be in [1, 64], got {out['channels']}")
        if not 8 <= out["chunk_frames"] <= 16384:
            raise RequestError(
                f"chunk_frames must be in [8, 16384], got {out['chunk_frames']}"
            )
        return p, out

    def _gc_streams(self) -> None:
        cutoff = time.monotonic() - self.cfg.stream_idle_timeout_s
        with self._streams_lock:
            for sid in [s for s, v in self._streams.items() if v.last_used < cutoff]:
                del self._streams[sid]

    def _get_stream(self, query: str, extra_params=()) -> tuple[_StreamSession, dict]:
        raw = urllib.parse.parse_qs(query, keep_blank_values=True)
        unknown = set(raw) - {"session", "format"} - set(extra_params)
        if unknown:
            raise RequestError(f"unknown parameter(s): {sorted(unknown)}")
        sid = raw.get("session", [None])[-1]
        if not sid:
            raise RequestError("missing session=<id> (from /stream/open)")
        with self._streams_lock:
            sess = self._streams.get(sid)
        if sess is None:
            raise RequestError(f"unknown or expired stream session: {sid}")
        fmt = raw.get("format", [sess.fmt])[-1]
        if fmt not in ("json", "npz"):
            raise RequestError("format must be 'json' or 'npz'")
        sess.last_used = time.monotonic()
        return sess, {"format": fmt}

    def stream_open(self, query: str) -> dict:
        p, sp = self._stream_session_params(query)
        config = self._config(sp["rate"], p)
        # A channel index past the declared channels is rejected here, not at
        # the first append.
        if str(p.get("channel", "0")).strip().lower() != "mix":
            if int(p.get("channel", "0")) >= sp["channels"]:
                raise RequestError(
                    f"channel {p.get('channel')} out of range: stream "
                    f"declares {sp['channels']} channel(s)"
                )
        self._gc_streams()
        with self._streams_lock:
            if len(self._streams) >= self.cfg.max_streams:
                raise TimeoutError(
                    f"too many open streams ({self.cfg.max_streams}); retry later"
                )
            sid = uuid.uuid4().hex
            sess = _StreamSession(
                sid, config, {**p, "encoding": sp["encoding"], "channels": sp["channels"]},
                self.stats, sp["chunk_frames"], self.device,
            )
            self._streams[sid] = sess
        self.stats.record_stream_session()
        return {
            "session": sid,
            "chunk_frames": sess.analyzer.chunk_frames,
            "frame_len": config.frame_len,
            "hop": config.hop,
            "sample_rate": sp["rate"],
            "encoding": sp["encoding"],
            "channels": sp["channels"],
            "viterbi": sess.viterbi,
        }

    def _stream_payload(self, sess, fmt, nf, feats, vit=None, closed=False):
        meta = {
            "session": sess.sid,
            "frames": nf,
            "frames_done": sess.analyzer.frames_done,
            "buffered_samples": sess.analyzer.buffered_samples,
        }
        if fmt == "npz":
            buf = io.BytesIO()
            arrays = dict(feats)
            if vit is not None:
                arrays.update({f"viterbi_{k}": v for k, v in vit.items()})
            np.savez(buf, **arrays)
            return "npz", buf.getvalue()
        out = {**meta, "features": {k: _jsonable(v) for k, v in feats.items()}}
        if vit is not None:
            out["viterbi"] = {k: _jsonable(v) for k, v in vit.items()}
        if closed:
            out["closed"] = True
        return "json", out

    def stream_append(self, query: str, body: bytes):
        sess, p = self._get_stream(query)
        with sess.lock:
            if sess.closed:
                raise RequestError("stream session already closed")
            nf, feats = sess.append(body)
            return self._stream_payload(sess, p["format"], nf, feats)

    def stream_close(self, query: str, body: bytes):
        """Close a session: an optional final PCM body is fed first, the
        partial tail chunk is flushed, and (if the session opened with
        viterbi=1) the whole-stream path search runs on the accumulated
        trimmed candidates: full-length f0/f0_strength/hnr_db come back
        under "viterbi" (JSON) / "viterbi_*" keys (npz)."""
        sess, p = self._get_stream(query)
        with sess.lock:
            if sess.closed:
                raise RequestError("stream session already closed")
            nf, feats, vit = sess.close(body)
            payload = self._stream_payload(
                sess, p["format"], nf, feats, vit=vit, closed=True
            )
        with self._streams_lock:
            self._streams.pop(sess.sid, None)
        return payload

    def stream_abort(self, query: str) -> dict:
        sess, _p = self._get_stream(query)
        with self._streams_lock:
            self._streams.pop(sess.sid, None)
        return {"session": sess.sid, "aborted": True,
                "frames_done": sess.analyzer.frames_done}

    # ---- lifecycle ---------------------------------------------------------

    def health(self) -> dict:
        """voxtpu's keys: the backend ("cuda" or "cpu") and its device count."""
        count = torch.cuda.device_count() if self.device.type == "cuda" else 1
        return {"status": "ok", "backend": self.device.type, "device_count": count}

    def warmup(self, sample_rate: float | None = None, shapes=None) -> None:
        """Build the kernels and run each warm shape once at the default
        config, so the first requests pay neither the kernels' build nor a
        first call's allocations.

        sample_rate: a single rate to warm; None warms every configured
        `allowed_rates` entry, falling back to 44.1 kHz when no rates are
        pinned.

        shapes: iterable of (B, Fp) pairs; default a lone small request (1,
        64) and a full batch at the top bucket (max_batch, bucket)."""
        rates = (
            (sample_rate,) if sample_rate is not None
            else (self.cfg.allowed_rates or (44100.0,))
        )
        if shapes is None:
            shapes = [(1, 64)]
            if self.cfg.bucket and self.cfg.bucket != 64:
                shapes.append((self.cfg.max_batch, self.cfg.bucket))
        for rate in rates:
            config = self._config(float(rate), dict(self.cfg.defaults))
            for B, rung in shapes:
                S = _samples_for_frames(config, rung)
                devices = self.devices if B >= len(self.devices) else self.devices[:1]
                _out, _m, timers = dispatch_split(
                    torch.zeros((B, S), dtype=torch.float32), torch.zeros((B,), dtype=torch.int64), config,
                    devices, rung,
                )
                for t in timers:
                    t.seconds()

    @property
    def address(self):
        return self.httpd.server_address[:2]

    def start(self):
        """Serve on a background thread (embedding/tests); returns (host, port)."""
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True, name="voxtpu-http")
        t.start()
        return self.address

    def serve_forever(self):
        host, port = self.address
        print(f"voxtpu serving on http://{host}:{port} "
              f"(window {self.cfg.window_ms} ms, max_batch {self.cfg.max_batch}, "
              f"bucket {self.cfg.bucket})", flush=True)
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.stop()
        with self._streams_lock:
            self._streams.clear()
