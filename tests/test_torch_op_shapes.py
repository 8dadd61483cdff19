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
  (the m-point DFTs as products with the DFT matrix, float32 in three TF32
  passes, the N1-point Stockham passes of tests/test_torch_ct_fused.py's
  model, the split, the fold, the inverse), equals np.fft within 1e-12 in
  float64 at all 153 new lengths, and the plain version within
  CT_FUSED_F32_TOL in float32 at the largest prime factor and at the
  largest and smallest odd factors; every index the kernel steps by
  addition equals its definition by the CRT maps at all 153 lengths;
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


def _tf32(a):
    """cvt.rna.tf32.f32: float32 values rounded to TF32's 10 mantissa bits,
    to nearest, ties away from zero."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma(a, b):
    """a @ b as the kernel's tensor cores form it: float64 as it is (the FP64
    tensor cores); float32 in three TF32 passes, a_lo b_hi + a_hi b_lo +
    a_hi b_hi (x_hi = tf32(x), x_lo = tf32(x - x_hi)), with float32 sums."""
    if a.dtype == np.float64:
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _model_ct_fused_pfa(x):
    """ct_fused_pfa_kernel's steps over (B, n) real frames, n = N1 m (N1 a
    power of two, m odd), in x's dtype: (half (B, n/2+1), ac (B, n)).

    With mh = (m + 1)/2, c = N1 mod m and the m roots r[e] = w_m^e = w^{2 N1
    e} from the twiddle table, the matrix B[k][n] = r[c k n mod m] (k, n <
    mh) as its real and imaginary parts C and -S. 1. The frame as it lies in
    memory, A[j1][i] = z[j1 + N1 i] (zero from n/2 on, i < mh), times C and
    S on the tensor cores (`_mma`): the four sums AC, BS, BC, AS give Y[k2]
    = r[j1 k2] ((AC + BS) + i (BC - AS)) and Y[m - k2] = conj(r[j1 k2])
    ((AC - BS) + i (BC + AS)) in row k2 of a buffer of m rows of N1 points;
    2. the rows' N1-point FFTs; 3. the split of each pair (k, n - k), k <=
    n/2, (k1, k2) = (k m^-1 mod N1, k N1^-1 mod m); 4. the rows' inverse
    FFTs; 5. the fold, a = V[k2] conj(r[j1 k2]), b = V[m - k2] r[j1 k2], P
    = a + b, M = a - b (k2 = 0: P = V[0], M = 0), and the outputs j = j1 +
    N1 i < n/2 as (C P_re - S M_im) + i (C P_im + S M_re) over N."""
    B, n = x.shape
    rdt = x.dtype.type
    cdt = np.complex64 if rdt is np.float32 else np.complex128
    n1 = n & -n
    m, nh = n // n1, n // 2
    mh = (m + 1) // 2
    ang = 2.0 * np.pi * np.arange(n) / (2 * n)
    tw = (np.cos(ang).astype(rdt) + 1j * (-np.sin(ang)).astype(rdt)).astype(cdt)  # ops/ct_fused.py's table
    r = _tw_at(tw, 2 * n1 * np.arange(m))
    h = np.arange(mh)
    e = (n1 % m) * np.outer(h, h) % m
    bc, bs = r.real[e], -r.imag[e]
    zp = np.zeros((B, mh * n1), cdt)
    zp[:, :nh] = x[:, 0::2] + 1j * x[:, 1::2]
    a = zp.reshape(B, mh, n1).transpose(0, 2, 1)
    ar, ai = a.real.copy(), a.imag.copy()
    AC, BS, BC, AS = _mma(ar, bc), _mma(ai, bs), _mma(ai, bc), _mma(ar, bs)
    om = r[(np.arange(n1) % m)[:, None] * h[None, :] % m]  # r[j1 k2]
    Y = np.empty((B, m, n1), cdt)
    Y[:, :mh] = (((AC + BS) + 1j * (BC - AS)).astype(cdt) * om).transpose(0, 2, 1)
    Y[:, m - h[1:]] = (((AC - BS) + 1j * (BC + AS)).astype(cdt) * np.conj(om))[:, :, 1:].transpose(0, 2, 1)
    Z = _rows_fft(Y.reshape(B * m, n1), tw, False).reshape(B, m, n1)
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
    va = V[:, h].transpose(0, 2, 1) * np.conj(om)
    vb = V[:, (m - h) % m].transpose(0, 2, 1) * om
    P, M = va + vb, va - vb
    P[:, :, 0], M[:, :, 0] = V[:, 0], 0
    re = _mma(P.real.copy(), bc) + _mma(-M.imag, bs)
    im = _mma(P.imag.copy(), bc) + _mma(M.real.copy(), bs)
    y = (re + 1j * im).astype(cdt).transpose(0, 2, 1).reshape(B, mh * n1)[:, :nh] * rdt(1.0 / (2 * n))
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
    """Float32 arithmetic and the TF32 passes at 20,096 = 128 x 157, the
    largest prime factor: within CT_FUSED_F32_TOL of each frame's largest
    value of the plain version, the card's tolerance for the kernel."""
    n = 20096
    x = _frames(n, 3, np.float32, seed=9)
    half, ac = _model_ct_fused_pfa(x)
    assert half.dtype == np.float32 and ac.dtype == np.float32
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    assert _frame_scaled_err(half, hp.numpy()) <= CT_FUSED_F32_TOL
    assert _frame_scaled_err(ac, ap.numpy()) <= CT_FUSED_F32_TOL


@pytest.mark.parametrize("n", [20608, 12288])
def test_pfa_model_f32_at_the_odd_factors_ends(n):
    """The same at the largest odd factor, 20,608 = 128 x 161 (the longest
    K loops of the TF32 products), and the smallest, 12,288 = 4096 x 3
    (the longest rows), against the plain version and the float64 FFT."""
    x = _frames(n, 3, np.float32, seed=5)
    half, ac = _model_ct_fused_pfa(x)
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    hf, af = _fft_reference(x)
    assert max(_frame_scaled_err(half, hp.numpy()), _frame_scaled_err(ac, ap.numpy())) <= CT_FUSED_F32_TOL
    assert max(_frame_scaled_err(half, hf), _frame_scaled_err(ac, af)) <= CT_FUSED_F32_TOL


def _mod_m(a, m):
    """ModM: a mod m by the float32 reciprocal of m, the product truncated,
    and one correction each way."""
    a = np.asarray(a, np.int64)
    q = np.trunc(a.astype(np.float32) * (np.float32(1) / np.float32(m))).astype(np.int64)
    r = a - q * m
    r = np.where(r < 0, r + m, r)
    return np.where(r >= m, r - m, r)


# The kernel's fragment shapes (csrc/ct_fused.cu's Tc): float32 m16n8k8, float64 m8n8k4.
_TC = {"f32": dict(kM=16, kN=8, kK=8, kP=8), "f64": dict(kM=8, kN=8, kK=4, kP=4)}


def _frag_rows_cols(dname):
    """Per lane (g, t) = (lane / 4, lane % 4): the (row, col) of each A
    element, the K row of each B element, the (row, col) of each C element."""
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    if dname == "f32":
        a = [(g + 8 * (e & 1), t + 4 * (e >> 1)) for e in range(4)]
        b = [t + 4 * e for e in range(2)]
        c = [(g + 8 * (e >> 1), 2 * t + (e & 1)) for e in range(4)]
    else:
        a, b, c = [(g, t)], [t], [(g, 2 * t + e) for e in range(2)]
    return g, t, a, b, c


@pytest.mark.parametrize("n", NEW_NS)
def test_pfa_index_walks_match_the_crt_maps(n):
    """Every index the prime-factor kernel steps by addition (csrc/ct_fused.cu),
    in both fragment shapes, against its definition by the CRT maps:
    - ModM equals % on every argument the kernel gives it;
    - the B fragments' walk along K (BWalk) reads r[c k n mod m], and
      r[(j1 + c i) k2] = r[(j mod m) k2] for j = j1 + N1 i: the product with
      the fixed matrix and the turn by r[j1 k2] give w_m^{j2 k2};
    - step 1 reads each of the n/2 points once a chunk, and writes each of
      the m rows' N1 columns once, its turn index et = j1 k2 mod m;
    - the fold's index e = j1 k2 mod m at each (j1, k2), each pair once;
    - step 5 writes each output j < n/2 once;
    - the split's k2, stepped by kPfaThreads N1^-1 mod m, is k N1^-1 mod m,
      and (k1, k2) is k's CRT pair: k = m k1 + N1 k2 mod n."""
    n1 = n & -n
    m, nh = n // n1, n // 2
    mh, c = (m + 1) // 2, n1 % m
    threads = {"f32": ct_fused._pfa_threads(n, torch.float32), "f64": ct_fused._pfa_threads(n, torch.float64)}
    args = []

    def walk(start, step, count):
        """start, start + step, ... mod m as the kernel steps them: e += step; e -= e >= m ? m : 0."""
        out = [start]
        for _ in range(count - 1):
            e = out[-1] + step
            out.append(np.where(e >= m, e - m, e))
        return out

    for dname, tc in _TC.items():
        kM, kN, kK, kP = tc["kM"], tc["kN"], tc["kK"], tc["kP"]
        g, t, a_el, b_el, c_el = _frag_rows_cols(dname)
        reads, outs = np.zeros(nh, np.int64), np.zeros(nh, np.int64)
        writes = np.zeros((m, n1), np.int64)
        if mh <= kP:
            # Pack: one tile, `groups` groups of mhp = 2^sh, block-diagonal.
            sh = (mh - 1).bit_length()
            groups, lo = kP >> sh, (1 << sh) - 1
            span = groups * kM
            stride = threads[dname] // 32 * span
            j0 = np.arange(0, n1, span)[:, None]
            # The tile at j0 = 0 as a product: A (kM x kK) from the points each
            # lane loads, B (kK x kN) block-diagonal, w_m^{c k n} in its group's
            # block; each live C element is its column's sum over i < mh.
            z = np.exp(1j * np.arange(nh))
            A, Bm = np.zeros((kM, kK), complex), np.zeros((kK, kN), complex)
            for ar, ac_ in a_el:
                i = ac_ & lo
                j = np.where(i < mh, i * n1, nh) + (ac_ >> sh) * kM + ar
                A[ar, ac_] = np.where(j < nh, z[np.minimum(j, nh - 1)], 0)
            for br in b_el:
                live = ((br >> sh) == (g >> sh)) & ((g >> sh) < groups) & ((br & lo) < mh) & ((g & lo) < mh)
                args += [c * (br & lo) * (g & lo)]
                Bm[br, g] = np.where(live, np.exp(-2j * np.pi * _mod_m(c * (br & lo) * (g & lo), m) / m), 0)
            C = A @ Bm
            for cr, cc in c_el:
                for lane in range(32):
                    k2 = cc[lane] & lo
                    if (cc[lane] >> sh) < groups and k2 < mh:
                        j1 = (cc[lane] >> sh) * kM + cr[lane]
                        i = np.arange(mh)
                        jj = i * n1 + j1
                        want = (np.where(jj < nh, z[np.minimum(jj, nh - 1)], 0) * np.exp(-2j * np.pi * c * i * k2 / m)).sum()
                        assert abs(C[cr[lane], cc[lane]] - want) < 1e-9
            for ar, ac_ in a_el:  # step 1's points and step 5's folded rows
                aoff = (ac_ >> sh) * kM + ar
                i = ac_ & lo
                j = np.where(i < mh, i * n1, nh) + j0 + aoff
                np.add.at(reads, j[j < nh], 1)
                for cr, cc in c_el:  # an A column and a C column of one group share their columns j1
                    same = (ac_ >> sh)[:, None] == (cc >> sh)[None, :]
                    assert ((aoff - ar)[:, None] == ((cc >> sh) * kM)[None, :])[same].all()
            for cr, cc in c_el:
                coff = (cc >> sh) * kM + cr
                k2 = np.broadcast_to(np.where(((cc >> sh) < groups) & ((cc & lo) < mh), cc & lo, mh), (len(j0), 32))
                j1 = j0 + coff
                ok = k2 < mh
                np.add.at(writes, (k2[ok], j1[ok]), 1)
                np.add.at(writes, ((m - k2)[ok & (k2 > 0)], j1[ok & (k2 > 0)]), 1)
                k2z = np.where(k2 < mh, k2, 0)
                args += [coff + np.arange(0, threads[dname] // 32)[:, None] * span, stride]
                for w in range(threads[dname] // 32):  # each warp's turn index, stepped from its first tile
                    first = w * span
                    e = _mod_m(_mod_m(first + coff, m) * k2z[0], m)
                    for jj in range(first, n1, stride):
                        assert np.array_equal(e[ok[0]], ((jj + coff) * k2z[0])[ok[0]] % m)
                        e = e + _mod_m(_mod_m(stride, m) * k2z[0], m)
                        e = np.where(e >= m, e - m, e)
                j = np.where(((cc >> sh) < groups) & ((cc & lo) < mh), (cc & lo) * n1, nh) + j0 + coff
                np.add.at(outs, j[j < nh], 1)
            assert (reads == 1).all() and (writes == 1).all() and (outs == 1).all()
            continue
        tiles, ksteps = -(-mh // kN), -(-mh // kK)
        for tile in range(tiles):
            col = tile * kN + g  # the B column of each lane
            args += [kK * c * col] + [c * br * col for br in b_el]
            for br in b_el:
                got = walk(_mod_m(c * br * col, m), _mod_m(kK * c * col, m), ksteps)
                assert all(np.array_equal(e, c * (br + kK * k) * col % m) for k, e in enumerate(got))
        j0 = np.arange(0, n1, kM)[:, None]  # every M tile, against every lane
        for k in range(ksteps):
            for ar, ac_ in a_el:
                j = ((k * kK + ac_) * n1 + j0 + ar).ravel()
                reads += np.bincount(j[j < nh], minlength=nh)
        assert (reads == 1).all()
        # Step 1's writes and turns (chunk kPfaChunk), step 5's outputs (kPfaChunk5).
        for chunk, step1 in ((ct_fused._PFA_CHUNK, True), (ct_fused._PFA_CHUNK5, False)):
            for t0 in range(0, tiles, chunk):
                for cr, cc in c_el:
                    j1 = np.broadcast_to(j0 + cr, (len(j0), 32))
                    k2s = [(t0 + q) * kN + np.broadcast_to(cc, j1.shape) for q in range(chunk)]
                    if step1:
                        jm = _mod_m(j1, m)
                        args += [j1, jm * k2s[0], kN * jm]
                        turns = walk(_mod_m(jm * k2s[0], m), _mod_m(kN * jm, m), chunk)
                    for q, k2 in enumerate(k2s):
                        ok = (t0 + q < tiles) & (k2 < mh)
                        if step1:
                            assert np.array_equal(turns[q][ok], (j1 * k2)[ok] % m)
                            np.add.at(writes, (k2[ok], j1[ok]), 1)
                            np.add.at(writes, ((m - k2)[ok & (k2 > 0)], j1[ok & (k2 > 0)]), 1)
                        else:  # outputs j = i N1 + j1, i = k2
                            j = k2 * n1 + j1
                            np.add.at(outs, j[(t0 + q < tiles) & (j < nh)], 1)
        assert (writes == 1).all() and (outs == 1).all()
    # The CRT identity behind step 1's split of w_m^{j k2}.
    j = np.arange(n)[:, None]
    assert np.array_equal((j % n1 + c * (j // n1)) * np.arange(m) % m, (j % m) * np.arange(m) % m)
    for threads in sorted(set(threads.values())):
        # The fold: kPer threads a column, each every kPer-th k2 from 1 + tid / kCols.
        cols = min(n1, threads)
        per = threads // cols
        tid = np.arange(threads)[:, None]
        j1 = tid % cols + np.arange(0, n1, cols)[None, :]
        first = np.broadcast_to(1 + tid // cols, j1.shape)
        jm = _mod_m(j1, m)
        args += [per * jm, jm * first]
        fold = np.zeros((m, n1), np.int64)
        for i, e in enumerate(walk(_mod_m(jm * first, m), _mod_m(per * jm, m), -(-mh // per))):
            k = first + i * per
            ok = k < mh
            assert np.array_equal(e[ok], (j1 * k)[ok] % m)
            np.add.at(fold, (k[ok], j1[ok]), 1)
            np.add.at(fold, ((m - k)[ok], j1[ok]), 1)
        assert (fold[1:] == 1).all() and (fold[0] == 0).all()
        # The split: k = tid + s kPfaThreads <= n/2, k2 stepped from (tid N1^-1) mod m.
        inv_m, inv_n1 = pow(m, -1, n1), pow(n1, -1, m)
        tid = np.arange(threads)
        steps = -(-(nh + 1) // threads)
        for s_, k2 in enumerate(walk(tid * inv_n1 % m, threads * inv_n1 % m, steps)):
            k = tid + s_ * threads
            live = k <= nh
            k1 = (k * inv_m) & (n1 - 1)
            assert np.array_equal(k2[live], (k * inv_n1 % m)[live])
            assert np.array_equal(((m * k1 + n1 * k2) % n)[live], k[live])
    a = np.concatenate([np.ravel(v) for v in args])
    assert a.max() < 1 << 24 and np.array_equal(_mod_m(a, m), a % m)


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
