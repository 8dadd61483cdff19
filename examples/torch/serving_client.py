"""Serving example on voxtpu_torch, the twin of examples/serving_client.py:
start the daemon in-process and drive it like a client.

In production you'd run the daemon standalone

    python -m voxtpu_torch serve --port 8080

and POST WAV bytes from anywhere:

    curl -s --data-binary @speech.wav \\
        'localhost:8080/analyze?viterbi=1&format=json' | jq .features.f0

Run: python examples/torch/serving_client.py [--device cuda|cpu]
"""

import argparse
import http.client
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _post(host, port, path, body=b""):
    conn = http.client.HTTPConnection(host, port, timeout=900)
    conn.request("POST", path, body=body)
    resp = json.loads(conn.getresponse().read())
    conn.close()
    return resp


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; 'cpu' runs on the CPU)")
    args = p.parse_args(argv)

    import numpy as np

    from voxtpu_torch.io_wav import read_wav
    from voxtpu_torch.serve import ServeConfig, VoxServer

    srv = VoxServer(ServeConfig(port=0, window_ms=2.0, max_batch=4, bucket=64, device=args.device))
    host, port = srv.start()
    try:
        wav = os.path.join(ROOT, "tests", "fixtures", "short_sample.wav")
        with open(wav, "rb") as f:
            body = f.read()
        resp = _post(host, port, "/analyze?fmax=500", body)
        f0 = resp["features"]["f0"]
        print(f"{resp['frames']} frames @ {resp['sample_rate']:.0f} Hz "
              f"(frame {resp['frame_len']}, hop {resp['hop']})")
        print("f0 track:", " ".join(f"{v:.1f}" for v in f0))

        # Streaming: raw PCM appends, features back per completed chunk,
        # whole-stream Viterbi at close.
        data = read_wav(wav, dtype=np.float32)
        pcm = np.ascontiguousarray(data.samples, dtype=np.float32).tobytes()
        sid = _post(host, port, f"/stream/open?rate={data.sample_rate}&viterbi=1&chunk_frames=8")["session"]
        n_chunks = 0
        for i in range(0, len(pcm), 16384):
            r = _post(host, port, f"/stream/append?session={sid}", pcm[i:i + 16384])
            n_chunks += int(r["frames"] > 0)
        final = _post(host, port, f"/stream/close?session={sid}")
        vf0 = final["viterbi"]["f0"]
        print(f"streamed {final['frames_done']} frames in {n_chunks + 1} chunk responses; viterbi f0 track: "
              + " ".join(f"{v:.1f}" for v in vf0[:8]) + " ...")

        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        print(f"server stats: {stats['requests']} request(s), batches {stats['batch_size_hist']}, "
              f"shapes {stats['compiled_shapes']}, stream chunks {stats['stream_chunks']}")
    finally:
        srv.shutdown()


if __name__ == "__main__":
    main()
