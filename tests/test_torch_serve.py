"""`voxtpu_torch.serve` (the port of voxtpu.serve) on the CPU.

Three kinds of checks, all at the small 8 kHz configuration of
tests/test_serve_stream.py (16 ms / 8 ms frames, bucket 64):
- host logic against voxtpu.serve on the same inputs, exactly: `_params`,
  `_stream_session_params`, `_select_channel`, `_jsonable`, `_frame_host`,
  `_pow2_batch`, `ServeConfig`'s fields and defaults, `/stats` keys;
- the same /analyze requests, good and bad, sent to a voxtpu server and to
  the port's: equal status codes, error texts, metadata and frame counts,
  and features, both float32, within the fast-mode budgets of
  tests/test_fast_mode.py:70-77 (f0 0.7 Hz on frames voiced in voxtpu,
  strength 1e-2, formants 2.5 Hz, MFCC 1e-4) on a clean synthetic vowel.
  The voxtpu server compiles one program (every good request is one shape);
- the port against itself at tests/test_serve.py's tolerances: /analyze
  equals `analyze`, npz round-trips, concurrent requests coalesce and each
  equals its own `analyze`, viterbi=1 equals `pitch_path_host` over the
  trimmed candidates, errors leave the daemon up, locked overrides,
  allowed rates, submit after stop, and the device rule (`NoCudaDevice`
  without a card, `data_parallel` above the card count refused);
- data parallelism over the CPU listed several times: a server at
  data_parallel 2 answers with the data_parallel 1 server's bytes, and
  `dispatch_split` over four listed CPUs equals one dispatch, and it
  refuses a batch the devices do not divide.
"""

import http.client
import io
import json
import struct
import threading
import time
import types
import wave

import numpy as np
import pytest
import torch

from voxtpu import serve as jserve
from voxtpu_torch import serve as tserve
from voxtpu_torch.cli import build_analysis_config
from voxtpu_torch.device import NoCudaDevice
from voxtpu_torch.pipeline import analyze
from voxtpu_torch.viterbi import PathConfig, pitch_path_host

SR = 8000
DEFAULTS = {"frame_ms": 16.0, "hop_ms": 8.0}
BUDGETS = {"f0": 0.7, "f0_strength": 1e-2, "formant_freqs": 2.5, "mfcc": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vowel(seconds=0.4, f0=130.0, seed=0, gain=0.5):
    """A clean synthetic vowel: harmonics of f0 under formant peaks at 700,
    1200 and 2500 Hz, with a little noise."""
    t = np.arange(int(SR * seconds)) / SR
    x = np.zeros_like(t)
    for h in range(1, int(3800 / f0)):
        fh = h * f0
        amp = sum(1.0 / (1.0 + ((fh - fc) / bw) ** 2) for fc, bw in ((700, 90), (1200, 110), (2500, 160)))
        x += amp / h * np.sin(2 * np.pi * fh * t)
    x = gain * x / np.max(np.abs(x))
    return (x + 1e-3 * np.random.default_rng(seed).standard_normal(t.shape)).astype(np.float32)


def _wav(x, channels=1, rate=SR, width=2) -> bytes:
    """PCM WAV bytes: width 2 is 16-bit integer, 4 is 32-bit IEEE float;
    x is (L,) or (L, channels)."""
    x = np.asarray(x, np.float32).reshape(-1, channels)
    if width == 2:
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(channels)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        return buf.getvalue()
    data = x.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, channels, rate, rate * 4 * channels, 4 * channels, 32)
    return (b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE" + b"fmt "
            + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data)


def _post(host, port, body, query="", path="/analyze", timeout=600.0):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    conn.request("POST", f"{path}?{query}" if query else path, body=body)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=60.0)
    conn.request("GET", path)
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, json.loads(data)


def _port_server(**kw):
    kw.setdefault("window_ms", 1.0)
    srv = tserve.VoxServer(tserve.ServeConfig(
        host="127.0.0.1", port=0, bucket=64, defaults=dict(DEFAULTS), device="cpu", **kw,
    ))
    return srv, *srv.start()


# ---------- host logic against voxtpu.serve --------------------------------


def _fake(mod, **cfg):
    """An object with `cfg` and `_params` that the servers' parameter
    methods accept as `self` (no socket, no dispatcher)."""
    ns = types.SimpleNamespace(cfg=mod.ServeConfig(defaults=dict(DEFAULTS), **cfg))
    ns._params = lambda q: mod.VoxServer._params(ns, q)
    return ns


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except jserve.RequestError as e:
        return ("RequestError", str(e))
    except tserve.RequestError as e:
        return ("RequestError", str(e))


PARAM_QUERIES = [
    "", "frame_ms=20&hop_ms=5", "fmin=80&fmax=400&threshold=0.3", "n_coeffs=10&mfcc_coeffs=12",
    "features=pitch,mfcc", "pitch_refine=parabolic&refine_depth=70", "viterbi=1", "viterbi=YES",
    "viterbi=0", "channel=mix", "channel=1&format=npz", "frame_ms=10&frame_ms=30", "bogus_param=1",
    "hop_ms=0", "frame_ms=-5", "frame_ms=abc", "fmin=700&fmax=600", "fmin=0", "n_coeffs=0",
    "mfcc_coeffs=1.5", "refine_depth=0", "pitch_refine=bogus", "channel=-1", "channel=abc",
    "format=xml", "threshold=&fmin=80",
]


@pytest.mark.parametrize("locked", [False, True])
def test_params_match_voxtpu(locked):
    """Same dict, or the same RequestError text, for every query."""
    j, t = _fake(jserve, allow_param_overrides=not locked), _fake(tserve, allow_param_overrides=not locked)
    for q in PARAM_QUERIES:
        assert _outcome(t._params, q) == _outcome(j._params, q), q


STREAM_QUERIES = [
    "rate=8000", "rate=8000&encoding=s16le&channels=2&channel=1", "rate=8000&chunk_frames=16",
    "", "rate=abc", "rate=0", "rate=8000&encoding=mp3", "rate=8000&channels=0", "rate=8000&channels=65",
    "rate=8000&channels=x", "rate=8000&chunk_frames=4", "rate=8000&chunk_frames=20000",
    "rate=8000&fmin=100", "rate=8000&viterbi=1&format=npz", "rate=8000&bogus=1",
]


@pytest.mark.parametrize("locked", [False, True])
def test_stream_session_params_match_voxtpu(locked):
    j, t = _fake(jserve, allow_param_overrides=not locked), _fake(tserve, allow_param_overrides=not locked)
    for q in STREAM_QUERIES:
        got = _outcome(tserve.VoxServer._stream_session_params, t, q)
        want = _outcome(jserve.VoxServer._stream_session_params, j, q)
        if "chunk_frames overrides are disabled" in str(want[1]):
            # The reason in parentheses names voxtpu's compiled programs.
            assert got[1].startswith("chunk_frames overrides are disabled on this server"), q
            continue
        assert got == want, q


@pytest.mark.parametrize("channel", ["0", "1", "2", "mix", " MIX ", "-1", "x", "3"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_select_channel_matches_voxtpu(channel, channels):
    x = np.random.default_rng(channels).standard_normal((50, channels)).astype(np.float32)
    x = x[:, 0] if channels == 1 else x
    got, want = _outcome(tserve._select_channel, x, channel), _outcome(jserve._select_channel, x, channel)
    assert got[0] == want[0]
    if got[0] == "ok":
        np.testing.assert_array_equal(got[1][0], want[1][0])
        assert got[1][1] == want[1][1]
    else:
        assert got[1] == want[1]


def test_jsonable_frame_host_and_pow2_match_voxtpu():
    rng = np.random.default_rng(1)
    values = [
        rng.standard_normal((5, 3)).astype(np.float32), np.array([1.0, -np.inf, np.nan, np.inf], np.float32),
        np.array([True, False]), np.arange(6, dtype=np.int32).reshape(2, 3), np.zeros(0, np.float64),
    ]
    for v in values:
        assert tserve._jsonable(v) == jserve._jsonable(v)
        assert json.dumps(tserve._jsonable(v)) == json.dumps(jserve._jsonable(v))
    x = rng.standard_normal(1000).astype(np.float32)
    for n, hop in ((128, 64), (100, 33), (1000, 7)):
        np.testing.assert_array_equal(tserve._frame_host(x, n, hop), jserve._frame_host(x, n, hop))
    assert _outcome(tserve._frame_host, x, 1001, 64) == _outcome(jserve._frame_host, x, 1001, 64)
    for b in range(1, 20):
        for mb in (1, 4, 8, 16):
            assert tserve._pow2_batch(b, mb) == jserve._pow2_batch(b, mb)


def test_serve_config_and_stats_keys_match_voxtpu():
    tfields = {k: v for k, v in vars(tserve.ServeConfig()).items() if k != "device"}
    assert tfields == vars(jserve.ServeConfig())
    assert tserve.ServeConfig().device is None
    assert tserve._Stats().snapshot().keys() == jserve._Stats().snapshot().keys()
    assert tserve._ALLOWED_PARAMS == jserve._ALLOWED_PARAMS


# ---------- responses against voxtpu -----------------------------------------


@pytest.fixture(scope="module")
def servers():
    """A voxtpu server and the port's, same config. Every good request below
    is one recording length, so voxtpu compiles one program (1, 64, 128)."""
    jsrv = jserve.VoxServer(jserve.ServeConfig(host="127.0.0.1", port=0, window_ms=1.0, bucket=64,
                                               defaults=dict(DEFAULTS)))
    jaddr = jsrv.start()
    tsrv, *taddr = _port_server()
    yield jaddr, tuple(taddr), jsrv, tsrv
    jsrv.shutdown()
    tsrv.shutdown()


STEREO = np.stack([_vowel(f0=180.0, seed=3), _vowel(seed=4)], axis=1)
GOOD = [
    ("s16 mono", _wav(_vowel()), ""),
    ("s16 mono npz", _wav(_vowel()), "format=npz"),
    ("float mono", _wav(_vowel(gain=1.5), width=4), ""),
    ("stereo channel 1", _wav(STEREO, channels=2), "channel=1"),
    ("stereo mix npz", _wav(STEREO, channels=2), "channel=mix&format=npz"),
    ("viterbi", _wav(_vowel(f0=150.0, seed=5)), "viterbi=1"),
]
SHORT = (b"RIFF" + struct.pack("<I", 36 + 16) + b"WAVEfmt " + struct.pack("<IHHIIHH", 16, 1, 1, SR, 2 * SR, 2, 16)
         + b"data" + struct.pack("<I", 16) + b"\x00" * 16)
BAD = [
    ("not a wav", b"not a wav at all", ""), ("empty", b"", ""), ("short", SHORT, ""),
    ("unknown param", _wav(_vowel()), "bogus_param=1"), ("channel 3", _wav(_vowel()), "channel=3"),
    ("channel 2 of 2", _wav(STEREO, channels=2), "channel=2"), ("hop 0", _wav(_vowel()), "hop_ms=0"),
    ("fmin > fmax", _wav(_vowel()), "fmin=700&fmax=600"), ("feature typo", _wav(_vowel()), "features=pitch,fromants"),
    ("refine depth 0", _wav(_vowel()), "refine_depth=0"), ("format xml", _wav(_vowel()), "format=xml"),
]


def _features(status, data, fmt):
    if fmt == "npz":
        with np.load(io.BytesIO(data)) as z:
            return None, {k: z[k] for k in z.files}
    resp = json.loads(data)
    feats = {k: np.asarray([np.nan if v is None else v for v in np.ravel(np.asarray(vals, dtype=object))],
                           dtype=np.float64).reshape(np.shape(vals)) for k, vals in resp.pop("features").items()}
    return resp, feats


def _within_budgets(name, got, want):
    voiced = want["f0"] > 0
    np.testing.assert_allclose(got["f0"][voiced], want["f0"][voiced], atol=BUDGETS["f0"], err_msg=name)
    for key in ("f0_strength", "formant_freqs", "mfcc"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=BUDGETS[key], err_msg=f"{name} {key}")
    np.testing.assert_allclose(got["rms"], want["rms"], rtol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got["status"], want["status"])


@pytest.mark.parametrize("name,body,query", GOOD, ids=[g[0] for g in GOOD])
def test_responses_match_voxtpu(servers, name, body, query):
    jaddr, taddr, _j, _t = servers
    (js, jd), (ts, td) = _post(*jaddr, body, query), _post(*taddr, body, query)
    assert ts == js == 200, (td[:300], jd[:300])
    fmt = "npz" if "format=npz" in query else "json"
    jmeta, jf = _features(js, jd, fmt)
    tmeta, tf = _features(ts, td, fmt)
    assert tmeta == jmeta
    assert tf.keys() == jf.keys()
    for k in tf:
        assert tf[k].shape == jf[k].shape, k
    _within_budgets(name, tf, jf)


def test_error_responses_match_voxtpu(servers):
    jaddr, taddr, _j, _t = servers
    for name, body, query in BAD:
        (js, jd), (ts, td) = _post(*jaddr, body, query), _post(*taddr, body, query)
        assert (ts, json.loads(td)) == (js, json.loads(jd)), name
        assert ts == 400, name
    for addr in (jaddr, taddr):
        assert _get(*addr, "/nope")[0] == 404
        assert _post(*addr, b"x", path="/nope")[0] == 404
    (jh, jhealth), (th, thealth) = _get(*jaddr, "/healthz"), _get(*taddr, "/healthz")
    assert th == jh == 200 and thealth.keys() == jhealth.keys()
    assert thealth == {"status": "ok", "backend": "cpu", "device_count": 1}


# ---------- the port against itself ------------------------------------------


@pytest.fixture(scope="module")
def server():
    """The port's server with a long gather window, so that concurrent
    requests coalesce."""
    srv, host, port = _port_server(window_ms=500.0, max_batch=4)
    yield host, port, srv
    srv.shutdown()


def _analyze_direct(x, rate=float(SR)):
    cfg = build_analysis_config(rate, **DEFAULTS)
    return cfg, {k: v.numpy() for k, v in analyze(torch.as_tensor(x), cfg).items()}


def test_serve_matches_direct_analyze_and_npz_roundtrips(server):
    host, port, _srv = server
    x = _vowel(seed=7)
    body = _wav(x)
    status, data = _post(host, port, body)
    assert status == 200, data
    resp, feats = _features(status, data, "json")
    want_x = (np.clip(x, -1, 1) * 32767).astype("<i2").astype(np.float32) / 32767.0
    _cfg, direct = _analyze_direct(want_x)
    assert resp["frames"] == direct["rms"].shape[0] and resp["sample_rate"] == float(SR)
    for k in ("f0", "rms", "formant_freqs", "mfcc"):
        np.testing.assert_allclose(feats[k], direct[k], rtol=1e-4, atol=1e-4, err_msg=k)
    status, data = _post(host, port, body, query="format=npz")
    assert status == 200
    _, npz = _features(status, data, "npz")
    np.testing.assert_allclose(npz["rms"], feats["rms"], rtol=1e-6, atol=1e-7)
    assert set(npz) >= {"f0", "rms", "formant_freqs", "mfcc", "status"}
    assert npz["status"].dtype == np.int32 and npz["pitch_candidates_valid"].dtype == bool


def test_serve_micro_batches_concurrent(server):
    """Concurrent requests of different lengths on one rung coalesce into
    one dispatch, and each gets its own recording's answer."""
    host, port, srv = server
    xs = [_vowel(seconds=s, f0=f, seed=i) for i, (s, f) in enumerate(((0.3, 120.0), (0.4, 160.0), (0.5, 200.0)))]
    before = srv.stats.snapshot()
    results = [None] * len(xs)

    def go(i):
        results[i] = _post(host, port, _wav(xs[i], width=4), query="format=npz")

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for x, (status, data) in zip(xs, results):
        assert status == 200, data
        _, feats = _features(status, data, "npz")
        _cfg, direct = _analyze_direct(x)
        for k in ("f0", "f0_strength", "rms", "formant_freqs", "mfcc", "status"):
            np.testing.assert_allclose(feats[k], direct[k], rtol=1e-5, atol=1e-5, err_msg=k)
    after = srv.stats.snapshot()
    assert after["batched_requests"] - before["batched_requests"] == len(xs)
    assert after["batches"] - before["batches"] < len(xs), (before, after)
    assert any(int(k) >= 2 for k in after["batch_size_hist"])


def test_serve_viterbi_runs_on_trimmed_candidates(server):
    """viterbi=1 equals the path search over the trimmed candidates the
    server returned (the module server pads 49 frames to the 64 rung)."""
    host, port, _srv = server
    x = _vowel(f0=140.0, seed=8)
    x[len(x) // 2 :] *= 0.01  # a quiet tail: the silence-aware unvoiced score
    status, data = _post(host, port, _wav(x, width=4), query="viterbi=1&format=npz")
    assert status == 200, data
    _, feats = _features(status, data, "npz")
    cfg = build_analysis_config(float(SR), **DEFAULTS)
    frames = tserve._frame_host(x, cfg.frame_len, cfg.hop)
    lp = np.max(np.abs(frames), axis=-1)
    assert feats["f0"].shape == (frames.shape[0],)
    f0, s0 = pitch_path_host(feats["pitch_candidates_freq"], feats["pitch_candidates_strength"],
                             feats["pitch_candidates_valid"], PathConfig(ceiling=cfg.pitch.fmax),
                             local_intensity=lp / np.maximum(np.max(lp), 1e-30))
    np.testing.assert_array_equal(feats["f0"], f0)
    np.testing.assert_array_equal(feats["f0_strength"], s0)
    # The candidates are the batch's, with or without the path search.
    _, plain = _features(*_post(host, port, _wav(x, width=4), query="format=npz"), "npz")
    np.testing.assert_array_equal(plain["pitch_candidates_freq"], feats["pitch_candidates_freq"])


def test_serve_errors_do_not_kill_daemon_and_stats(server):
    host, port, _srv = server
    for body, query in ((b"not a wav", ""), (_wav(_vowel()), "bogus_param=1"), (b"", ""), (SHORT, "")):
        assert _post(host, port, body, query)[0] == 400
    assert _get(host, port, "/healthz")[1]["status"] == "ok"
    status, data = _post(host, port, _wav(_vowel()))
    assert status == 200, data
    status, stats = _get(host, port, "/stats")
    assert status == 200 and stats["requests"] >= 5 and stats["errors"] >= 4
    assert stats["latency_ms"]["p50"] is not None and stats["compiled_shapes"]
    assert stats["device_time_s"] > 0


def test_serve_locked_param_overrides_and_allowed_rates():
    srv, host, port = _port_server(allow_param_overrides=False, allowed_rates=(16000.0,))
    try:
        status, data = _post(host, port, b"x", query="fmin=100")
        assert status == 400 and b"disabled" in data
        # Host-side params stay available (the decode failure shows the gate passed).
        status, data = _post(host, port, b"x", query="format=npz&viterbi=1")
        assert status == 400 and b"cannot decode" in data
        status, data = _post(host, port, _wav(_vowel()))
        assert status == 400 and b"not served" in data and b"16000" in data
    finally:
        srv.shutdown()


def test_submit_after_stop_fails_fast():
    b = tserve._MicroBatcher(tserve.ServeConfig(request_timeout_s=300.0), tserve._Stats(), [torch.device("cpu")])
    b.stop()
    item = tserve._Pending(np.zeros(8, np.float32), 1)
    t0 = time.monotonic()
    b.submit(("k", 4, 8), item)
    assert item.event.wait(5.0), "post-stop submit left its waiter hanging"
    assert item.error == "server shutting down"
    assert time.monotonic() - t0 < 2.0


def test_failed_dispatch_answers_500_and_warmup_runs(monkeypatch):
    """A dispatch that raises answers its waiters with 500 and the daemon
    stays up; warmup runs each warm shape of each allowed rate."""
    srv, host, port = _port_server(allowed_rates=(8000.0, 16000.0))
    try:
        srv.warmup(shapes=[(1, 64)])
        with monkeypatch.context() as m:
            m.setattr(tserve, "_analyze_batch_padded_packed", lambda *a, **k: 1 / 0)
            status, data = _post(host, port, _wav(_vowel()))
        assert status == 500 and b"ZeroDivisionError" in data
        assert _post(host, port, _wav(_vowel()))[0] == 200
    finally:
        srv.shutdown()


def test_device_rule_and_data_parallel(monkeypatch):
    """Without a card and without device="cpu" the server refuses to start;
    data_parallel keeps voxtpu's checks and refuses more cards than there
    are (voxtpu/serve.py:258-260), before it touches one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tserve.VoxServer(tserve.ServeConfig(port=0))
    with pytest.raises(ValueError, match="power of two"):
        tserve.VoxServer(tserve.ServeConfig(port=0, data_parallel=3, device="cpu"))
    with pytest.raises(ValueError, match="max_batch"):
        tserve.VoxServer(tserve.ServeConfig(port=0, data_parallel=8, max_batch=4, device="cpu"))
    with pytest.raises(ValueError, match="data_parallel 2 > 1 devices"):
        tserve.VoxServer(tserve.ServeConfig(port=0, data_parallel=2, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="data_parallel 4 > 2 devices"):
        tserve.VoxServer(tserve.ServeConfig(port=0, data_parallel=4))


def _responses(srv_kw, bodies, query="format=npz"):
    """Every body posted at once to a new server (a long gather window, so
    they coalesce into one batch); the raw responses and /stats."""
    srv, host, port = _port_server(window_ms=500.0, max_batch=4, **srv_kw)
    try:
        results = [None] * len(bodies)

        def go(i):
            results[i] = _post(host, port, bodies[i], query=query)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        return results, _get(host, port, "/stats")[1]
    finally:
        srv.shutdown()


def test_data_parallel_2_answers_with_the_dp_1_bytes(monkeypatch):
    """data_parallel 2 over the CPU listed twice: a batch of 2 or 3
    requests (B = 2 or 4) splits into two blocks, and each answer equals the
    data_parallel 1 server's, byte for byte."""
    bodies = [_wav(_vowel(seconds=s, f0=f, seed=i), width=4)
              for i, (s, f) in enumerate(((0.3, 120.0), (0.4, 160.0), (0.5, 200.0)))]
    one, stats1 = _responses({}, bodies)
    monkeypatch.setattr(tserve, "local_devices", lambda device: [torch.device("cpu")] * 2)
    two, stats2 = _responses({"data_parallel": 2}, bodies)
    for (st1, d1), (st2, d2) in zip(one, two):
        assert st1 == st2 == 200, (d1[:300], d2[:300])
        assert d1 == d2
    # Coalesced (B >= 2), so the batch split over both blocks.
    assert any(int(k) >= 2 for k in stats2["batch_size_hist"]) and stats2["device_time_s"] > 0


def test_dispatch_split_over_four_equals_one_dispatch():
    """`dispatch_split` over four listed CPUs (one recording a block)
    against one dispatch of the whole batch, with the per-recording path
    search on (tests/test_serve.py:103-135 holds voxtpu's sharded program
    to its single-device one the same way)."""
    import dataclasses

    cfg = build_analysis_config(float(SR), **DEFAULTS)
    cfg = dataclasses.replace(cfg, pitch=dataclasses.replace(cfg.pitch, viterbi=True))
    xs = [_vowel(seconds=0.2 + 0.1 * i, f0=110.0 + 30 * i, seed=i) for i in range(4)]
    S = tserve._samples_for_frames(cfg, 64)
    stack = torch.zeros((4, S), dtype=torch.float32)
    lengths = torch.zeros((4,), dtype=torch.int64)
    for i, x in enumerate(xs):
        stack[i, : len(x)] = torch.as_tensor(x)
        lengths[i] = len(x)
    outs = {}
    for n in (1, 4):
        out, manifest, timers = tserve.dispatch_split(stack, lengths, cfg, [torch.device("cpu")] * n, 64)
        assert len(timers) == n and all(t.seconds() >= 0 for t in timers)
        outs[n] = tserve._unpack_frames(out.numpy(), manifest)
    assert outs[1].keys() == outs[4].keys()
    for k in outs[1]:
        np.testing.assert_array_equal(outs[4][k], outs[1][k], err_msg=k)


def test_dispatch_split_refuses_a_batch_the_devices_do_not_divide():
    """A batch that does not split into equal row blocks raises before any
    launch, as voxtpu's packed analysis does (voxtpu/serve.py:257-258)."""
    cfg = build_analysis_config(float(SR), **DEFAULTS)
    S = tserve._samples_for_frames(cfg, 64)
    stack = torch.zeros((3, S), dtype=torch.float32)
    lengths = torch.zeros((3,), dtype=torch.int64)
    with pytest.raises(ValueError, match="batch 3 not divisible by 2 devices"):
        tserve.dispatch_split(stack, lengths, cfg, [torch.device("cpu")] * 2, 64)
