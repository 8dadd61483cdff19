"""Every op shape voxtpu's kernels take: kernel E at the frame lengths that
are not powers of two, and kernel D past 16 estimates, on the CPU.

voxtpu's fused autocorrelation op (voxtpu/ops/ct_fused_pallas.py) takes
nfft = 2n for every multiple of 128 up to 20,608; its McCandless scan
(voxtpu/ops/formant_scan_pallas.py) takes up to LANES = 128 estimates. The
port's kernels (csrc/ct_fused.cu, csrc/formant_scan.cu) run on the card
only; here, on the same inputs made from a seed with numpy:
- E's gate equals voxtpu's for every multiple of 64 up to 65,536 at nfft =
  n, 2n and 4n, in both dtypes;
- E's wrapper on CPU tensors (its plain version) equals voxtpu's op in
  interpret mode at four of the new lengths: float64 within 1e-12 of each
  frame's largest value, float32 within CT_FUSED_F32_TOL;
- `_model_ct_fused_pfa`, a NumPy model of the prime-factor kernel's steps
  (the index maps, the m-point DFTs, the N1-point Stockham passes of
  tests/test_torch_ct_fused.py's model, the split, the inverse), equals
  np.fft within 1e-12 in float64 at all 153 new lengths, and the plain
  version within CT_FUSED_F32_TOL in float32 at the largest prime factor;
- routing: the entry points' shapes (nfft = next_pow2(2n)) never reach E at
  these lengths, and an explicit nfft = 2n takes E where voxtpu's gate
  does;
- the constants mirror csrc/ct_fused.cu and csrc/formant_scan.cu;
- D's plain version equals voxtpu's tracker bit for bit at 20 estimates
  (the Pallas kernel in interpret mode) and 128 (its `lax.scan`: the
  interpret-mode kernel takes about two minutes to compile at 128 lanes on
  the CPU), in both dtypes; the model of D's schedule equals the plain
  scan at 17, 64 and 128 estimates;
- `analyze_frames` with 24 starting estimates equals voxtpu's on
  short_sample.wav at tests/test_torch_pipeline.py's tolerances.
"""

import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtpu import pipeline as jp
from voxtpu.formants import formant_tracker as jax_tracker
from voxtpu.io_wav import read_wav
from voxtpu.ops.ct_fused_pallas import ct_fused_power_ac as jax_ct_fused_power_ac
from voxtpu.ops.ct_fused_pallas import ct_fused_supported as jax_ct_fused_supported
from voxtpu.ops.formant_scan_pallas import LANES

from chip_smoke import CT_FUSED_F32_TOL, SCAN_LS, extended_estimates
from test_torch_ct_fused import _fft_reference, _frame_scaled_err, _radix_plan, _split_power, _stockham_pass, _tw_at
from test_torch_formant_scan import _speculate_repair
from test_torch_pipeline import KEYS, _assert_key
from voxtpu_torch import autocorr
from voxtpu_torch.frame import frame_signal
from voxtpu_torch.ops import ct_fused, formant_scan
from voxtpu_torch.pipeline import analyze_frames, config_from_jax

CSRC = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc"
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# The multiples of 128 up to 20,608 that are not powers of two.
NEW_NS = [n for n in range(128, 20608 + 1, 128) if n & (n - 1)]
jax_tracker = jax.jit(jax_tracker, static_argnames="backend")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, B, dt=np.float64, seed=17):
    return np.random.default_rng(seed + n).standard_normal((B, n)).astype(dt)


def test_new_lengths():
    """153 lengths, odd parts 3 to 161, the largest prime factor 157."""
    odd = [n // (n & -n) for n in NEW_NS]
    assert len(NEW_NS) == 153 and min(odd) == 3 and max(odd) == 161
    assert 20096 in NEW_NS and 20096 // (20096 & -20096) == 157


# --- kernel E: the gate, the plain version, the model, routing


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_equals_voxtpus(dtype):
    """For every multiple of 64 up to 65,536, at nfft = n, 2n and 4n: the
    port admits what voxtpu's fused gate admits (which sizes its VMEM in
    4-byte items, in any dtype)."""
    for n in range(64, 65536 + 1, 64):
        for nfft in (n, 2 * n, 4 * n):
            assert ct_fused.ct_fused_supported(n, nfft, dtype) == jax_ct_fused_supported(n, nfft), (n, nfft)
    assert ct_fused.ct_fused_supported(20608, 41216, dtype) and not ct_fused.ct_fused_supported(20736, 41472, dtype)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("n", [384, 640, 1152, 2176])
def test_wrapper_matches_voxtpu_at_new_lengths(n, dt):
    """`ct_fused_power_ac` on CPU tensors against voxtpu's op in interpret
    mode, per frame relative to its largest value: float64 within 1e-12,
    float32 within CT_FUSED_F32_TOL."""
    x = _frames(n, 2, dt)
    half, ac = ct_fused.ct_fused_power_ac(torch.as_tensor(x), 2 * n)
    jh, ja = (np.asarray(v) for v in jax_ct_fused_power_ac(jnp.asarray(x), 2 * n, interpret=True))
    assert half.dtype == torch.from_numpy(x).dtype and half.shape == jh.shape and ac.shape == ja.shape
    tol = 1e-12 if dt == np.float64 else CT_FUSED_F32_TOL
    assert _frame_scaled_err(half.numpy(), jh) <= tol
    assert _frame_scaled_err(ac.numpy(), ja) <= tol


def _rows_fft(rows, tw, inverse):
    """The N1-point transform of each row by the kernels' Stockham passes
    (row_ffts: pass 0 turns nothing)."""
    Ns = 1
    for R in _radix_plan(rows.shape[-1]):
        rows = _stockham_pass(rows, R, Ns, tw, inverse)
        Ns *= R
    return rows


def _model_ct_fused_pfa(x):
    """ct_fused_pfa_kernel's steps over (B, n) real frames, n = N1 m (N1 a
    power of two, m odd), in x's dtype: (half (B, n/2+1), ac (B, n)).

    Time index j lies at (j2, j1) = (j mod m, j mod N1) of a buffer of m rows
    of N1 points, frequency index k = (m k1 + N1 k2) mod n at (k2, k1). 1.
    The m-point DFTs of the n/2 nonzero points over j2 with the roots w_m^e =
    w^{2 N1 e} from the twiddle table; 2. the rows' N1-point FFTs; 3. the
    split of each pair (k, n - k), k <= n/2, (k1, k2) = (k m^-1 mod N1, k
    N1^-1 mod m); 4. the rows' inverse FFTs; 5. the inverse m-point DFTs to
    the outputs j < n/2, over N = 2n. The DFTs are products with the m x m
    matrix of roots: the kernel sums the same terms, one at a time."""
    B, n = x.shape
    rdt = x.dtype.type
    cdt = np.complex64 if rdt is np.float32 else np.complex128
    n1 = n & -n
    m, nh = n // n1, n // 2
    ang = 2.0 * np.pi * np.arange(n) / (2 * n)
    tw = (np.cos(ang).astype(rdt) + 1j * (-np.sin(ang)).astype(rdt)).astype(cdt)  # ops/ct_fused.py's table
    roots = _tw_at(tw, 2 * n1 * np.arange(m))[np.outer(np.arange(m), np.arange(m)) % m]  # w_m^{j2 k2}
    j = np.arange(nh)
    grid = np.zeros((B, m, n1), cdt)
    grid[:, j % m, j % n1] = x[:, 0::2] + 1j * x[:, 1::2]
    Z = _rows_fft((roots @ grid).reshape(B * m, n1), tw, False).reshape(B, m, n1)
    k = np.arange(nh + 1)
    k1, k2 = k * pow(m, -1, n1) % n1, k * pow(n1, -1, m) % m
    p1, p2 = -k1 % n1, -k2 % m  # n - k
    pk, pn = _split_power(Z[:, k2, k1], np.conj(Z[:, p2, p1]), tw[k], rdt)
    half = np.empty((B, nh + 1), x.dtype)
    even = k[k % 2 == 0]
    half[:, (n - even) // 2] = pn[:, even]
    half[:, even // 2] = pk[:, even]  # k = n/2 writes P[k] last
    S, D = pk + pn, pk - pn
    W = np.empty_like(Z)
    mid = (k > 0) & (k < nh)
    W[:, p2[mid], p1[mid]] = ((S - tw[k].imag * D) + 1j * (tw[k].real * D)).astype(cdt)[:, mid]
    W[:, k2, k1] = ((S + tw[k].imag * D) + 1j * (tw[k].real * D)).astype(cdt)
    V = _rows_fft(W.reshape(B * m, n1), tw, True).reshape(B, m, n1)
    y = (np.conj(roots) @ V)[:, j % m, j % n1] * rdt(1.0 / (2 * n))
    return half, np.stack([y.real, y.imag], axis=-1).reshape(B, n)


@pytest.mark.parametrize("n", NEW_NS)
def test_pfa_model_matches_fft_f64(n):
    x = _frames(n, 2, seed=3)
    half, ac = _model_ct_fused_pfa(x)
    hf, af = _fft_reference(x)
    assert half.shape == hf.shape and ac.shape == af.shape
    assert _frame_scaled_err(half, hf) <= 1e-12
    assert _frame_scaled_err(ac, af) <= 1e-12


def test_pfa_model_matches_plain_f32():
    """Float32 arithmetic throughout at 20,096 = 128 x 157, the largest
    prime factor: within CT_FUSED_F32_TOL of each frame's largest value of
    the plain version, the card's tolerance for the kernel."""
    n = 20096
    x = _frames(n, 3, np.float32, seed=9)
    half, ac = _model_ct_fused_pfa(x)
    assert half.dtype == np.float32 and ac.dtype == np.float32
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    assert _frame_scaled_err(half, hp.numpy()) <= CT_FUSED_F32_TOL
    assert _frame_scaled_err(ac, ap.numpy()) <= CT_FUSED_F32_TOL


def test_layouts():
    """Shared memory holds the frame and its m roots in float32 at every
    length and in float64 up to 14,336; above, float64 takes the scratch
    buffer in device memory (48 lengths). Powers of two keep their layout."""
    f64 = {n: ct_fused.ct_fused_layout(n, torch.float64) for n in NEW_NS}
    assert all(ct_fused.ct_fused_layout(n, torch.float32) == "shared" for n in NEW_NS)
    assert [n for n, v in f64.items() if v == "device"] == [n for n in NEW_NS if n > 14336]
    assert sum(v == "device" for v in f64.values()) == 48
    assert all(ct_fused.ct_fused_smem_bytes(n, dt) <= ct_fused.SMEM_LIMIT
               for n in NEW_NS for dt in (torch.float32, torch.float64))
    assert ct_fused.ct_fused_smem_bytes(20608, torch.float32) == (20608 + 161) * 8
    assert ct_fused.ct_fused_smem_bytes(20608, torch.float64) == 161 * 16
    assert ct_fused.ct_fused_layout(4096, torch.float64) == "registers"
    assert all(ct_fused.ct_fused_cluster(n, torch.float64) == 1 for n in NEW_NS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_routing_at_new_lengths(dtype):
    """The entry points pass nfft = next_pow2(2n) (voxtpu/autocorr.py:67,
    157), which no length that is not a power of two reaches E with: they
    take "fft" as before. An explicit nfft = 2n takes E exactly where
    voxtpu's fused gate admits the shape; the CPU runs E's plain version."""
    for n in NEW_NS + [96, 300, 2205, 20736]:
        nfft = 1 << (2 * n - 1).bit_length()
        for half in (False, True):
            assert autocorr._backend(None, n, nfft, dtype, half=half) == "fft"
            assert autocorr._backend("ct_fused", n, nfft, dtype, half=half) == "fft"
            e = "ct_fused" if jax_ct_fused_supported(n, 2 * n) else "fft"
            assert autocorr._backend("ct_fused", n, 2 * n, dtype, half=half) == e
            assert autocorr._backend(None, n, 2 * n, dtype, half=half) == e


def _const(path, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", path.read_text()).group(1))


def test_constants_mirror_the_cuda_sources():
    """E's largest frame, block shared memory and power-of-two factors, and
    D's estimate cap, which is voxtpu's LANES."""
    cu = CSRC / "ct_fused.cu"
    assert _const(cu, "kMaxN") == ct_fused.MAX_N[torch.float32] == ct_fused.MAX_N[torch.float64] == 20608
    assert _const(cu, "kSmemLimit") == ct_fused.SMEM_LIMIT
    q = {(n & -n).bit_length() - 1 for n in NEW_NS}
    assert (_const(cu, "kPfaMinLog2"), _const(cu, "kPfaMaxLog2")) == (min(q), max(q)) == (7, 12)
    assert _const(CSRC / "formant_scan.cu", "kMaxL") == formant_scan._MAX_L == LANES == 128


# --- kernel D past 16 estimates


def _resonances(dt, F=300, R=12, seed=0):
    rng = np.random.default_rng(seed)
    rf = np.sort(rng.uniform(0.0, 5000.0, (F, R)), axis=1)
    rf[100:140] = 0.0  # a span with no winner: the carry is held
    return torch.as_tensor(rf, dtype=dt), torch.as_tensor(rng.uniform(10.0, 400.0, (F, R)), dtype=dt)


def _seeds(L, dt):
    ef = torch.as_tensor(extended_estimates(L), dtype=dt)
    return ef, torch.ones_like(ef)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("L, backend", [(20, "pallas_interpret"), (128, "jnp")])
def test_scan_plain_equals_voxtpu(L, backend, dt):
    rf, rb = _resonances(dt)
    ef, eb = _seeds(L, dt)
    jf, jb = jax_tracker(*(jnp.asarray(t.numpy()) for t in (rf, rb, ef, eb)), backend=backend)
    tf, tb = formant_scan.formant_scan_plain(rf, rb, ef, eb)
    bits = np.int32 if dt == torch.float32 else np.int64
    np.testing.assert_array_equal(tf.numpy().view(bits), np.asarray(jf).view(bits))
    np.testing.assert_array_equal(tb.numpy().view(bits), np.asarray(jb).view(bits))
    assert torch.equal(tf[:, 6:], ef[6:].expand(len(rf), L - 6))  # estimates 6 on stay the seed


@pytest.mark.parametrize("L", SCAN_LS)
def test_schedule_model_equals_plain_scan(L):
    """Kernel D's schedule (tests/test_torch_formant_scan.py's model) over
    160 frames, the kernel's chunks and a short one that leaves many to
    repair."""
    rf, rb = _resonances(torch.float32, F=160)
    ef, eb = _seeds(L, torch.float32)
    want = formant_scan.formant_scan_plain(rf, rb, ef, eb)
    for chunk, warmup in ((formant_scan.CHUNK, formant_scan.WARMUP), (8, 4)):
        got_f, got_b, (_, rerun_chunks, _) = _speculate_repair(rf, rb, ef, eb, len(rf), chunk, warmup)
        assert torch.equal(got_f, want[0]) and torch.equal(got_b, want[1]), chunk
        assert chunk != 8 or rerun_chunks > 0  # the held span is re-run


def test_analyze_frames_with_24_estimates_matches_jax():
    """short_sample.wav at the verify skill's configuration (512/256, fmax
    500, order 10) with 24 starting estimates: every key at the slice
    tolerances; the formants (10, 24), estimates 6 on their seeds."""
    wav = read_wav(os.path.join(FIX, "short_sample.wav"))
    jcfg = jp.AnalysisConfig(
        sample_rate=11025.0, frame_len=512, hop=256,
        pitch=jp.PitchConfig(fmin=60.0, fmax=500.0, max_candidates=16),
        formant=jp.FormantConfig(n_coeffs=10, estimates=extended_estimates(24)),
    )
    frames = frame_signal(torch.as_tensor(np.asarray(wav.samples, dtype=np.float64)), 512, 256)
    want = {k: np.asarray(v) for k, v in jp.analyze_frames(jnp.asarray(frames.numpy()), jcfg).items()}
    got = {k: v.numpy() for k, v in analyze_frames(frames, config_from_jax(jcfg)).items()}
    for key in KEYS:
        _assert_key(key, got, want, 11025.0)
    assert got["formant_freqs"].shape == (10, 24)
    np.testing.assert_array_equal(got["formant_freqs"][:, 6:], np.broadcast_to(extended_estimates(24)[6:], (10, 18)))
