"""The port's /stream/* sessions and `StreamAnalyzer`'s hooks, on the CPU.

- **Hooks against voxtpu.** `StreamAnalyzer` with a `step` and with a
  `step_samples` hook that record what they receive, fed the same random
  block splits as `voxtpu.pipeline.StreamAnalyzer` with the same hooks: the
  sequence of (padded frames or samples, nf) each hook receives, and the
  trimmed chunks, are equal bit for bit.
- **Sessions against the port's own entry points** at tests/test_serve_stream.py's
  8 kHz configuration (16 ms / 8 ms frames, 8-frame chunks): an HTTP
  stream equals `analyze_long` at the same chunking (rtol 1e-9, MFCC 1e-5),
  also for two concurrent sessions and for a recording longer than
  `max_body_bytes`; a close with viterbi=1 equals `finalize_viterbi`;
  s16le stereo split mid-sample; npz; session errors, abort, idle GC, the
  503 at `max_streams`, `allowed_rates` and locked overrides.
"""

import dataclasses
import http.client
import io
import json
import threading
import time

import numpy as np
import pytest
import torch

from voxtpu import pipeline as jp
from voxtpu.pipeline import AnalysisConfig as JConfig
from voxtpu_torch import pipeline as tp
from voxtpu_torch import serve as tserve
from voxtpu_torch.cli import build_analysis_config
from voxtpu_torch.pipeline import config_from_jax

SR = 8000.0
CFG = build_analysis_config(SR, frame_ms=16.0, hop_ms=8.0)  # 128 / 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sine(seconds=1.0, f=220.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    x = 0.5 * np.sin(2 * np.pi * f * t)
    if noise:
        x = x + noise * rng.standard_normal(t.shape)
    return x.astype(np.float32)


# ---------- StreamAnalyzer's hooks against voxtpu's ---------------------------


class _Recorder:
    """A hook that records (what it got, nf) and returns a chunk whose rows
    are numbered, so the trimming shows; `est` counts the calls."""

    def __init__(self, to_numpy, arange, zeros):
        self.calls, self.to_numpy, self.arange, self.zeros = [], to_numpy, arange, zeros

    def __call__(self, data, nf, est):
        self.calls.append((self.to_numpy(data), nf, est))
        rows = self.to_numpy(data).shape[0] if self.to_numpy(data).ndim == 2 else 8
        return {"row": self.arange(rows), "_stream_local_peak": self.zeros(rows)}, (est or 0) + 1


def _jax_hook():
    import jax.numpy as jnp

    return _Recorder(np.asarray, jnp.arange, jnp.zeros)


def _torch_hook():
    return _Recorder(lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), torch.arange, torch.zeros)


@pytest.mark.parametrize("hook", ["step", "step_samples"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hooks_receive_what_voxtpu_hooks_receive(hook, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(rng.integers(2000, 6000))).astype(np.float32)
    cuts = np.sort(rng.integers(0, len(x), int(rng.integers(1, 12))))
    blocks = np.split(x, cuts)
    jcfg = JConfig(SR, CFG.frame_len, CFG.hop)
    tcfg = config_from_jax(jcfg)
    chunk_frames = int(rng.integers(8, 24))
    jh, th = _jax_hook(), _torch_hook()
    ja = jp.StreamAnalyzer(jcfg, chunk_frames, **{hook: jh})
    ta = tp.StreamAnalyzer(tcfg, chunk_frames, device="cpu", **{hook: th})
    jchunks, tchunks = [], []
    for b in blocks:
        jchunks += ja.feed(b)
        tchunks += ta.feed(b)
        assert ta.buffered_samples == ja.buffered_samples
    jchunks += ja.finish()
    tchunks += ta.finish()
    assert ta.frames_done == ja.frames_done > 0
    assert len(th.calls) == len(jh.calls) == len(tchunks) == len(jchunks) >= 2
    for (tg, tnf, test), (jg, jnf, jest) in zip(th.calls, jh.calls):
        assert (tnf, test) == (jnf, jest)
        assert tg.dtype == jg.dtype and tg.shape == jg.shape
        np.testing.assert_array_equal(tg, jg)
    for tc, jc in zip(tchunks, jchunks):
        assert tc.keys() == jc.keys()
        for k in tc:
            np.testing.assert_array_equal(np.asarray(tc[k]), np.asarray(jc[k]))


def test_both_hooks_at_once_is_an_error():
    with pytest.raises(ValueError, match="step or step_samples"):
        tp.StreamAnalyzer(CFG, 8, step=_torch_hook(), step_samples=_torch_hook())


# ---------- HTTP sessions --------------------------------------------------


def _make_server(**kw):
    srv = tserve.VoxServer(tserve.ServeConfig(
        host="127.0.0.1", port=0, window_ms=1.0, bucket=64, device="cpu",
        stream_chunk_frames=kw.pop("stream_chunk_frames", 8),
        defaults=kw.pop("defaults", {"frame_ms": 16.0, "hop_ms": 8.0}), **kw,
    ))
    host, port = srv.start()
    return srv, host, port


def _post(host, port, path, body=b"", timeout=600.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", path, body=body)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _stream(host, port, x, block, open_q, close_body=b""):
    """A full open/append*/close session; returns (concatenated features,
    the close response)."""
    st, d = _post(host, port, f"/stream/open?{open_q}")
    assert st == 200, d
    sid = json.loads(d)["session"]
    feats: dict = {}

    def take(resp):
        for k, v in resp["features"].items():
            feats.setdefault(k, []).extend(v)

    for i in range(0, len(x), block):
        st, d = _post(host, port, f"/stream/append?session={sid}", x[i : i + block].tobytes())
        assert st == 200, d
        take(json.loads(d))
    st, d = _post(host, port, f"/stream/close?session={sid}", close_body)
    assert st == 200, d
    resp = json.loads(d)
    take(resp)
    return feats, resp


def _long(x, chunk_frames=8, cfg=CFG):
    return {k: v.numpy() for k, v in tp.analyze_long(torch.as_tensor(x), cfg, chunk_frames=chunk_frames).items()}


def _assert_feats_match(feats, want, total_frames):
    assert total_frames == want["rms"].shape[0]
    for k in ("f0", "f0_strength", "rms", "formant_freqs", "formant_bws", "status", "pitch_candidates_freq"):
        np.testing.assert_allclose(np.asarray(feats[k], np.float64), want[k].astype(np.float64), rtol=1e-9,
                                   atol=0, err_msg=k)
    np.testing.assert_allclose(np.asarray(feats["mfcc"], np.float64), want["mfcc"].astype(np.float64), rtol=1e-5,
                               atol=1e-5, err_msg="mfcc")
    got = np.asarray([np.nan if v is None else v for v in feats["hnr_db"]], np.float64)  # -inf rides as null
    np.testing.assert_allclose(got, np.where(np.isfinite(want["hnr_db"]), want["hnr_db"], np.nan), rtol=1e-9,
                               atol=0, equal_nan=True)


def test_stream_http_equals_analyze_long():
    srv, host, port = _make_server()
    try:
        x = _sine(0.6, noise=0.01)
        feats, resp = _stream(host, port, x, block=1300, open_q="rate=8000&frame_ms=16&hop_ms=8")
        _assert_feats_match(feats, _long(x), resp["frames_done"])
        assert resp["closed"] is True
        snap = srv.stats.snapshot()
        assert snap["stream_chunks"] >= 3 and snap["stream_sessions"] == 1
        assert (1, 8, CFG.frame_len) in snap["compiled_shapes"]
    finally:
        srv.shutdown()


def test_stream_concurrent_sessions_are_isolated():
    """Two sessions at once, each on its handler thread: each carry is its
    session's own."""
    srv, host, port = _make_server()
    try:
        xs = [_sine(0.3, f=180.0, noise=0.01, seed=1), _sine(0.3, f=320.0, noise=0.01, seed=2)]
        out, errs = [None, None], []

        def go(i):
            try:
                out[i] = _stream(host, port, xs[i], block=811, open_q="rate=8000&frame_ms=16&hop_ms=8")
            except Exception as e:  # surface the assertion text, not a hang
                errs.append((i, repr(e)))

        ts = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errs, errs
        for i in range(2):
            _assert_feats_match(out[i][0], _long(xs[i]), out[i][1]["frames_done"])
    finally:
        srv.shutdown()


def test_stream_viterbi_close_equals_finalize_viterbi():
    """viterbi=1 at open: close's whole-stream track equals
    `finalize_viterbi` over the same chunking, bit for bit."""
    srv, host, port = _make_server()
    try:
        x = _sine(0.5, f=210.0, noise=0.002, seed=9)
        x[len(x) // 2 :] *= 0.001  # quiet tail: the silence-aware unvoiced score
        _feats, resp = _stream(host, port, x, block=911, open_q="rate=8000&frame_ms=16&hop_ms=8&viterbi=1")
        assert "viterbi" in resp
        chunks = list(tp.analyze_stream([torch.as_tensor(x)], CFG, chunk_frames=8))
        want = tp.finalize_viterbi(chunks, dataclasses.replace(CFG, pitch=dataclasses.replace(CFG.pitch, viterbi=True)))
        for k in ("f0", "f0_strength", "hnr_db"):
            got = np.asarray([np.nan if v is None else v for v in resp["viterbi"][k]], np.float64)
            w = want[k].numpy().astype(np.float64)
            np.testing.assert_array_equal(got, np.where(np.isfinite(w), w, np.nan), err_msg=k)
        assert len(resp["viterbi"]["f0"]) == resp["frames_done"]
    finally:
        srv.shutdown()


def test_stream_serves_recording_longer_than_max_body():
    srv, host, port = _make_server(max_body_bytes=20_000)
    try:
        x = _sine(1.5, noise=0.01, seed=2)  # 48 KB of f32 > the 20 KB cap
        big = io.BytesIO()
        import wave

        with wave.open(big, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(int(SR))
            w.writeframes((x * 32767).astype("<i2").tobytes())
        st, d = _post(host, port, "/analyze", big.getvalue())
        assert st == 400 and b"/stream/open" in d
        feats, resp = _stream(host, port, x, block=4500, open_q="rate=8000&frame_ms=16&hop_ms=8&chunk_frames=64")
        _assert_feats_match(feats, _long(x, chunk_frames=64), resp["frames_done"])
    finally:
        srv.shutdown()


def test_stream_s16le_stereo_channel_with_ragged_byte_splits():
    srv, host, port = _make_server()
    try:
        left, right = _sine(0.3, f=180.0, seed=3, noise=0.01), _sine(0.3, f=300.0, seed=4, noise=0.01)
        inter = np.empty(left.size * 2, dtype=np.float32)
        inter[0::2], inter[1::2] = left, right
        pcm = (np.clip(inter, -1, 1) * 32767).astype("<i2").tobytes()
        st, d = _post(host, port, "/stream/open?rate=8000&frame_ms=16&hop_ms=8&encoding=s16le&channels=2&channel=1")
        assert st == 200, d
        sid = json.loads(d)["session"]
        feats: dict = {}
        rng = np.random.default_rng(7)
        i = 0
        while i < len(pcm):
            k = int(rng.integers(333, 2001))  # odd sizes: split mid-sample
            st, d = _post(host, port, f"/stream/append?session={sid}", pcm[i : i + k])
            assert st == 200, d
            for kk, v in json.loads(d)["features"].items():
                feats.setdefault(kk, []).extend(v)
            i += k
        st, d = _post(host, port, f"/stream/close?session={sid}")
        assert st == 200, d
        for kk, v in json.loads(d)["features"].items():
            feats.setdefault(kk, []).extend(v)
        want_x = (np.clip(right, -1, 1) * 32767).astype("<i2").astype(np.float32) / 32767.0
        np.testing.assert_allclose(np.asarray(feats["f0"], np.float64), _long(want_x)["f0"].astype(np.float64),
                                   rtol=1e-9, atol=0)
    finally:
        srv.shutdown()


def test_stream_npz_format_roundtrip():
    srv, host, port = _make_server()
    try:
        x = _sine(0.6, noise=0.01)
        st, d = _post(host, port, "/stream/open?rate=8000&frame_ms=16&hop_ms=8&viterbi=1")
        sid = json.loads(d)["session"]
        st, d = _post(host, port, f"/stream/append?session={sid}&format=npz", x.tobytes())
        assert st == 200
        with np.load(io.BytesIO(d)) as arrs:
            assert "f0" in arrs.files and arrs["f0"].ndim == 1 and arrs["status"].dtype == np.int32
        st, d = _post(host, port, f"/stream/close?session={sid}&format=npz")
        assert st == 200
        with np.load(io.BytesIO(d)) as tail:
            assert set(tail.files) >= {"f0", "rms", "viterbi_f0", "viterbi_hnr_db"}
    finally:
        srv.shutdown()


def test_stream_session_errors_and_abort():
    srv, host, port = _make_server(allowed_rates=(8000.0,))
    try:
        for q, frag in [
            ("", b"requires rate"), ("rate=abc", b"bad value for rate"), ("rate=0", b"requires rate"),
            ("rate=8000&encoding=mp3", b"encoding"), ("rate=8000&channels=0", b"channels"),
            ("rate=8000&chunk_frames=4", b"chunk_frames"), ("rate=8000&channels=2&channel=5", b"out of range"),
            ("rate=44100", b"not served"),
        ]:
            st, d = _post(host, port, f"/stream/open?{q}")
            assert st == 400 and frag in d, (q, st, d[:200])
        st, d = _post(host, port, "/stream/append?session=nope", b"\0" * 8)
        assert st == 400 and b"unknown or expired" in d
        assert _post(host, port, "/stream/close?session=nope")[0] == 400
        st, d = _post(host, port, "/stream/open?rate=8000")
        sid = json.loads(d)["session"]
        st, d = _post(host, port, f"/stream/append?session={sid}")
        assert st == 400 and b"empty body" in d
        st, d = _post(host, port, f"/stream/append?session={sid}&bogus=1", b"\0" * 8)
        assert st == 400 and b"unknown parameter" in d
        st, d = _post(host, port, f"/stream/abort?session={sid}")
        assert st == 200 and json.loads(d)["aborted"] is True
        st, d = _post(host, port, f"/stream/append?session={sid}", b"\0" * 8)
        assert st == 400 and b"unknown or expired" in d
        st, d = _post(host, port, "/stream/open?rate=8000")
        sid = json.loads(d)["session"]
        assert _post(host, port, f"/stream/close?session={sid}")[0] == 200
        st, d = _post(host, port, f"/stream/close?session={sid}")
        assert st == 400 and b"unknown or expired" in d
        conn = http.client.HTTPConnection(host, port, timeout=60.0)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 200
        conn.close()
    finally:
        srv.shutdown()


def test_stream_locked_server_rejects_overrides_but_streams():
    srv, host, port = _make_server(allow_param_overrides=False)
    try:
        st, d = _post(host, port, "/stream/open?rate=8000&fmin=100")
        assert st == 400 and b"disabled" in d
        st, d = _post(host, port, "/stream/open?rate=8000&chunk_frames=16")
        assert st == 400 and b"chunk_frames overrides are disabled" in d
        st, d = _post(host, port, "/stream/open?rate=8000&viterbi=1&channel=0")
        assert st == 200, d
        sid = json.loads(d)["session"]
        st, d = _post(host, port, f"/stream/close?session={sid}", _sine(0.3).tobytes())
        assert st == 200 and "viterbi" in json.loads(d)
    finally:
        srv.shutdown()


def test_stream_idle_sessions_are_garbage_collected():
    srv, host, port = _make_server(stream_idle_timeout_s=0.05, max_streams=4)
    try:
        st, d = _post(host, port, "/stream/open?rate=8000")
        sid = json.loads(d)["session"]
        time.sleep(0.2)
        assert _post(host, port, "/stream/open?rate=8000")[0] == 200  # GC runs on the next open
        st, d = _post(host, port, f"/stream/append?session={sid}", b"\0" * 8)
        assert st == 400 and b"unknown or expired" in d
    finally:
        srv.shutdown()


def test_stream_max_sessions_503():
    srv, host, port = _make_server(max_streams=2)
    try:
        for _ in range(2):
            assert _post(host, port, "/stream/open?rate=8000")[0] == 200
        st, d = _post(host, port, "/stream/open?rate=8000")
        assert st == 503 and b"too many open streams" in d
    finally:
        srv.shutdown()
