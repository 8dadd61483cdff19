"""Kernel E's plain version and the port's autocorrelation routing against
voxtpu on the CPU.

`ct_fused_power_ac_plain` and `power_and_autocorrelate(backend="ct_fused")`
take the same float64 frames as voxtpu's fused Pallas kernel in interpret
mode, at the cases of tests/test_autocorr.py:135-169. Tolerances are that
test's: the half power spectrum rtol 1e-9 after dividing by its largest
value (the matmul DFT and the FFT round differently near zero bins), the
lags rtol 1e-9 / atol 1e-9. The shape gate is pinned case by case, as
tests/test_large_frames.py::test_ct_fused_vmem_budget_gate pins voxtpu's.

csrc/ct_fused.cu runs on the card only (chip_smoke.py holds it to the plain
version at every path's shapes and every n the gate admits). Here
`_model_ct_fused`, a NumPy model that follows the kernel's own steps (the
packing, the radix plan and its digit order, the split, the power and the
strided half, the inverse packing, the pruned last pass and the 1/N scale),
is held to `ct_fused_power_ac_plain`: index and twiddle faults show up
here before they cost time on the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voxtpu.autocorr as jac
from voxtpu.ops.ct_fused_pallas import ct_fused_power_ac as jax_ct_fused_power_ac

from chip_smoke import CT_FUSED_F32_TOL
from voxtpu_torch import autocorr
from voxtpu_torch.ops import ct_fused, kernels, viterbi

CU = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc" / "ct_fused.cu"

SHAPES = [(128, 3), (1024, 11), (4096, 5)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers on the CPU at once: one torch thread
    each keeps them from oversubscribing the cores (torch's default is a
    thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, B, seed=31):
    return np.random.default_rng(seed + n).standard_normal((B, n))


def _assert_half(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n, B", SHAPES)
def test_plain_matches_jax_fused_kernel(n, B):
    x = _frames(n, B)
    half, ac = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    jhalf, jac_ = jax_ct_fused_power_ac(jnp.asarray(x), 2 * n, interpret=True)
    assert half.shape == (B, n // 2 + 1) and ac.shape == (B, n)
    _assert_half(half.numpy(), np.asarray(jhalf))
    np.testing.assert_allclose(ac.numpy(), np.asarray(jac_), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n, B", SHAPES)
def test_power_and_autocorrelate_ct_fused_matches_jax(n, B):
    x = _frames(n, B, seed=7)
    half, ac = autocorr.power_and_autocorrelate(torch.as_tensor(x), backend="ct_fused")
    jhalf, jac_ = jac.power_and_autocorrelate(jnp.asarray(x), backend="ct_fused_interpret")
    _assert_half(half.numpy(), np.asarray(jhalf))
    np.testing.assert_allclose(ac.numpy(), np.asarray(jac_), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n, nc", [(256, 256), (512, 100)])
def test_autocorrelate_ct_fused_matches_jax(n, nc):
    x = _frames(n, 3, seed=33)
    got = autocorr.autocorrelate(torch.as_tensor(x), n_coeffs=nc, backend="ct_fused")
    want = jac.autocorrelate(jnp.asarray(x), n_coeffs=nc, backend="ct_fused_interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n, nfft, dtype, ok", [
    (1024, 2048, torch.float32, True),
    (2048, 4096, torch.float32, True),
    (4096, 8192, torch.float32, True),
    (1024, 2048, torch.float64, True),
    (2048, 4096, torch.float64, True),
    (4096, 8192, torch.float64, True),  # float64's largest frame of one block
    (128, 256, torch.float64, True),  # the smallest frame
    (8192, 16384, torch.float32, True),  # float32's largest frame of one block
    (8192, 16384, torch.float64, True),  # a cluster of 2 blocks
    (16384, 32768, torch.float32, True),  # the largest power of two, a cluster of 2 blocks
    (16384, 32768, torch.float64, True),  # the largest power of two, a cluster of 4 blocks
    (20608, 41216, torch.float32, True),  # the largest (MAX_N), 128 x 161, the prime-factor kernel
    (20608, 41216, torch.float64, True),  # its buffer in device memory
    (20736, 41472, torch.float32, False),  # above the largest, as voxtpu's gate
    (32768, 65536, torch.float32, False),
    (32768, 65536, torch.float64, False),
    (64, 128, torch.float32, False),  # below 128
    (96, 192, torch.float64, False),  # not a multiple of 128
    (1536, 3072, torch.float32, True),  # a multiple of 128, not a power of two: the prime-factor kernel
    (300, 1024, torch.float64, False),  # nfft != 2n
    (1024, 4096, torch.float32, False),  # nfft != 2n
    (1024, 2048, torch.float16, False),  # no half-precision kernel
])
def test_shape_gate(n, nfft, dtype, ok):
    assert ct_fused.ct_fused_supported(n, nfft, dtype) is ok


def test_shared_memory_sizer():
    """One exchange buffer of n complex values a frame: 32 KB in float32 and
    64 KB in float64 at the bench frame of 4096; frames under 2048 points
    share a block of 128 threads (16 frames of 128); a cluster's block
    holds its n / cluster points: 64 KB at 16,384 in float32 (2 blocks) and
    at 8,192 and 16,384 in float64 (2 and 4 blocks)."""
    assert ct_fused.ct_fused_smem_bytes(4096, torch.float32) == 32768
    assert ct_fused.ct_fused_smem_bytes(4096, torch.float64) == 65536
    assert ct_fused.ct_fused_smem_bytes(8192, torch.float32) == 65536
    assert ct_fused.ct_fused_smem_bytes(128, torch.float32) == 16 * 128 * 8
    assert ct_fused.ct_fused_smem_bytes(16384, torch.float32) == 65536
    assert ct_fused.ct_fused_smem_bytes(8192, torch.float64) == 65536
    assert ct_fused.ct_fused_smem_bytes(16384, torch.float64) == 65536
    assert [ct_fused.ct_fused_cluster(n, torch.float32) for n in (4096, 8192, 16384)] == [1, 1, 2]
    assert [ct_fused.ct_fused_cluster(n, torch.float64) for n in (4096, 8192, 16384)] == [1, 2, 4]
    assert ct_fused.SMEM_LIMIT == 227 * 1024


@pytest.mark.parametrize("dtype, largest", [(torch.float32, 20608), (torch.float64, 20608)])
def test_gate_admits_the_same_frame_lengths(dtype, largest):
    """The gate admits exactly the frame lengths voxtpu's fused gate takes,
    the multiples of 128 from 128 to 20,608 in either dtype (the powers of
    two among them up to 16,384), every block of them fits the card's
    shared memory, and a cluster has at most 4 blocks."""
    admitted = [n for n in range(1, 1 << 16) if ct_fused.ct_fused_supported(n, 2 * n, dtype)]
    assert admitted == list(range(128, largest + 1, 128))
    assert [n for n in admitted if n & (n - 1) == 0] == [1 << k for k in range(7, 15)]
    assert all(ct_fused.ct_fused_smem_bytes(n, dtype) <= ct_fused.SMEM_LIMIT for n in admitted)
    assert all(ct_fused.ct_fused_cluster(n, dtype) in (1, 2, 4) for n in admitted)


def test_constants_mirror_the_cuda_source():
    """The wrapper's points a thread, block floor, largest frame (the
    largest power of two: kMaxLog2) and per-dtype largest frame of one
    block (above which a frame takes a cluster) are csrc/ct_fused.cu's; so
    are the prime-factor kernel's threads a block (and where 512 take
    over) and its N tiles a warp holds in each m-point DFT."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kPoints") == ct_fused._POINTS
    assert const("kMinBlockThreads") == ct_fused._MIN_BLOCK_THREADS
    assert const("kMaxN") == ct_fused.MAX_N[torch.float32] == ct_fused.MAX_N[torch.float64]
    assert 1 << const("kMaxLog2") == max(n for n in range(128, const("kMaxN") + 1, 128) if n & (n - 1) == 0)
    assert 1 << const("kBlockLog2F32") == ct_fused._BLOCK_N[torch.float32]
    assert 1 << const("kBlockLog2F64") == ct_fused._BLOCK_N[torch.float64]
    assert const("kPfaThreads") == ct_fused._PFA_THREADS
    assert const("kPfaWideThreads") == ct_fused._PFA_WIDE_THREADS
    assert const("kPfaWideLog2") == ct_fused._PFA_WIDE_LOG2
    assert (const("kPfaChunk"), const("kPfaChunk5")) == (ct_fused._PFA_CHUNK, ct_fused._PFA_CHUNK5)


@pytest.mark.parametrize("n", [96, 300, 2205])
def test_unsupported_shapes_take_fft(n):
    """A "ct_fused" request for a shape the gate refuses runs torch.fft, as
    voxtpu falls back (voxtpu/autocorr.py:87-88); the kernel's wrapper itself
    raises for it."""
    x = torch.as_tensor(_frames(n, 2))
    for fn in (autocorr.autocorrelate, lambda *a, **k: autocorr.power_and_autocorrelate(*a, **k)[1]):
        np.testing.assert_array_equal(fn(x, 64, backend="ct_fused").numpy(), fn(x, 64, backend="fft").numpy())
    want = jac.autocorrelate(jnp.asarray(x.numpy()), 64, backend="fft")
    np.testing.assert_allclose(autocorr.autocorrelate(x, 64).numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="unsupported shape"):
        ct_fused.ct_fused_power_ac(x, 2 * n)


def test_default_backend_on_cpu_runs_the_plain_version():
    """backend=None picks kernel E for a power-of-two frame; on the CPU its
    plain version runs, which equals the fft branch bit for bit."""
    x = torch.as_tensor(_frames(512, 4))
    before = ct_fused.ct_fused_power_ac.launches
    h0, a0 = autocorr.power_and_autocorrelate(x)
    h1, a1 = autocorr.power_and_autocorrelate(x, backend="fft")
    assert torch.equal(h0, h1) and torch.equal(a0, a1)
    assert torch.equal(autocorr.autocorrelate(x, 100), autocorr.autocorrelate(x, 100, backend="fft"))
    assert ct_fused.ct_fused_power_ac.launches == before


@pytest.mark.parametrize("backend", ["ct_fused_fast", "ct_fused_interpret", "fft2", ""])
def test_unknown_backend_rejected(backend):
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="unknown backend"):
        autocorr.autocorrelate(x, 8, backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        autocorr.power_and_autocorrelate(x, 8, backend=backend)


def test_new_kernel_wrappers_raise_without_nvcc(monkeypatch, tmp_path):
    """Handed tensors they would launch on, E's and F's wrappers raise when
    the library cannot be built: they never answer with the plain version."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "library_path", lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(kernels, "on_cpu", lambda *t: False)
    kernels.library.cache_clear()
    try:
        with pytest.raises(kernels.KernelBuildError):
            ct_fused.ct_fused_power_ac(torch.zeros((2, 256)), 512)
        z = torch.zeros((5, 4), dtype=torch.float64)
        with pytest.raises(kernels.KernelBuildError):
            viterbi.viterbi_path(z, z + 1.0, z > 0, 0.35, 0.14)
        assert ct_fused.ct_fused_power_ac.launches == 0 and viterbi.viterbi_path.launches == 0
    finally:
        kernels.library.cache_clear()


# --- _model_ct_fused: csrc/ct_fused.cu's steps in NumPy

# cos and sin of 2 pi e / 16, e < 8: the radix-16 butterfly's constants
# (rot16; e = 4 is the exact quarter turn).
_COS16 = np.cos(2 * np.pi * np.arange(8) / 16)
_COS16[4] = 0.0
_SIN16 = np.sin(2 * np.pi * np.arange(8) / 16)


def _radix_plan(n):
    """The passes' radices (Plan::kPasses, kLast): 16s, the last 2^(log2 n mod 4)."""
    L = n.bit_length() - 1
    passes = -(-L // 4)
    return [16] * (passes - 1) + [1 << (L - 4 * (passes - 1))]


def _bitrev(i, bits):
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def _dft(v, inverse, zero_upper=False, half_out=False):
    """dft(): the R-point DFT over the last axis, radix-2 decimation in time
    over the bit-reversed copy; zero_upper: v[R/2:] is zero and not read;
    half_out: only outputs 0 .. R/2 are formed."""
    R = v.shape[-1]
    bits = R.bit_length() - 1
    u = v[..., [_bitrev(i, bits) for i in range(R)]].copy()
    s = 1
    if zero_upper:
        u[..., 1::2] = u[..., 0::2]
        s = 2
    while s < R:
        for i in range(R):
            if i & s:
                continue
            e = (i & (s - 1)) * (8 // s)
            b = u[..., i + s].copy()
            if e:
                b = b * np.asarray(_COS16[e] + (1j if inverse else -1j) * _SIN16[e], dtype=u.dtype)
            if half_out and 2 * s == R:
                u[..., i] = u[..., i] + b
                continue
            u[..., i + s] = u[..., i] - b
            u[..., i] = u[..., i] + b
        s *= 2
    return u[..., : R // 2] if half_out else u


def _stockham_pass(data, R, Ns, tw, inverse, zero_upper=False, half_out=False):
    """exchange_pass(): butterflies j < n/R read data[j + r n/R]; for Ns > 1,
    input r is turned by w^{r s}, s = (j mod Ns) N / (Ns R), from the table's
    w^s, w^2s, w^4s, w^8s and their products (twiddle()); the R-point DFT;
    output r lands at (j - j mod Ns) R + j mod Ns + r Ns. The table (len(tw)
    = nt values) may belong to a longer transform than this one's n points
    (a cluster's block): N = 2 nt."""
    B, n = data.shape
    span = n // R
    j = np.arange(span)
    v = data[:, j[:, None] + span * np.arange(R)[None, :]].copy()
    jm = j % Ns
    if Ns > 1:
        s = jm * (2 * len(tw) // (Ns * R))
        p = {}
        for lb in range(R.bit_length() - 1):
            w = tw[s << lb]
            p[1 << lb] = np.conj(w) if inverse else w
        for r in range(3, R):
            hb = 1 << (r.bit_length() - 1)
            if r != hb:
                p[r] = p[hb] * p[r - hb]
        for r in range(1, R):
            v[..., r] = v[..., r] * p[r]
    v = _dft(v, inverse, zero_upper, half_out)
    out = np.zeros_like(data)
    idx = (j - jm)[:, None] * R + jm[:, None] + Ns * np.arange(v.shape[-1])[None, :]
    out[:, idx] = v
    return out


def _split_power(A, Bc, tw, rdt):
    """The split and the power for each k: A = Z[k], Bc = conj Z[n-k], tw =
    w^k; (P[k], P[n-k]) = (|E - U|^2, |E + U|^2)."""
    E, O = (A + Bc) * rdt(0.5), (A - Bc) * rdt(0.5)
    U = 1j * (tw * O)
    d1, d2 = E - U, E + U
    return d1.real * d1.real + d1.imag * d1.imag, d2.real * d2.real + d2.imag * d2.imag


def _tw_at(tw, e):
    """tw_at(): w^e for 0 <= e < 2n from the table of w^k, k < n."""
    n = len(tw)
    return np.where(e >= n, -tw[e % n], tw[e % n])


def _model_ct_fused_cluster(x, C, tw, cdt):
    """ct_fused_cluster_kernel's steps over a cluster of C blocks: block c's
    m-point transform of y_c (pre-twiddled, and for C = 4 with the upper
    quarter folded in), the split of class c against class (C - c) mod C,
    the m-point inverse of W's class c, and the outputs t < n/2 as
    sum_c' w_n^{-c' t} V_c'[t mod m]."""
    B, n = x.shape
    rdt = x.dtype.type
    m = n // C
    plan = _radix_plan(m)
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(cdt)  # the n/2 nonzero points
    j = np.arange(m)
    Z = []
    for c in range(C):
        y = z[:, :m].copy()
        if C == 4:
            b = z[:, m : 2 * m]
            y = y + [b, b.imag - 1j * b.real, -b, -b.imag + 1j * b.real][c].astype(cdt)  # (-i)^c b
        if c:
            y = y * _tw_at(tw, 2 * j * c)
        Ns = 1
        for R in plan:
            y = _stockham_pass(y, R, Ns, tw, False)
            Ns *= R
        Z.append(y)
    half = np.zeros((B, n // 2 + 1), x.dtype)
    V = []
    q = np.arange(m)
    for c in range(C):
        k = C * q + c
        qp = (m - q) % m if c == 0 else m - 1 - q
        pk, pn = _split_power(Z[c][:, q], np.conj(Z[(C - c) % C][:, qp]), tw[k], rdt)
        if c % 2 == 0:
            half[:, k // 2] = pk
        if c == 0:
            half[:, n // 2] = pn[:, 0]
        S, D = pk + pn, pk - pn
        W = ((S + tw[k].imag * D) + 1j * (tw[k].real * D)).astype(cdt)
        Ns = 1
        for R in plan:
            W = _stockham_pass(W, R, Ns, tw, True)
            Ns *= R
        V.append(W)
    to = np.arange(n // 2)
    y = V[0][:, to % m]
    for c in range(1, C):
        y = y + V[c][:, to % m] * np.conj(_tw_at(tw, (2 * c * to) % (2 * n)))
    w = y * rdt(1.0 / (2 * n))
    return half, np.stack([w.real, w.imag], axis=-1).reshape(B, n)


def _model_ct_fused(x, cluster=1):
    """(B, n) real frames (float32 or float64, computed in that type) ->
    (half (B, n/2+1), ac (B, n)), by the kernel's steps; cluster: the blocks
    a frame takes (ct_fused_cluster), 1 for the single-block kernel."""
    B, n = x.shape
    rdt = x.dtype.type
    cdt = np.complex64 if rdt is np.float32 else np.complex128
    ang = 2.0 * np.pi * np.arange(n) / (2 * n)
    tw = (np.cos(ang).astype(rdt) + 1j * (-np.sin(ang)).astype(rdt)).astype(cdt)  # ops/ct_fused.py's table
    if cluster > 1:
        return _model_ct_fused_cluster(x, cluster, tw, cdt)
    plan = _radix_plan(n)
    # Forward: z[m] = x[2m] + i x[2m+1], zero from n/2 on.
    z = np.zeros((B, n), cdt)
    z[:, : n // 2] = x[:, 0::2] + 1j * x[:, 1::2]
    Ns = 1
    for p, R in enumerate(plan):
        z = _stockham_pass(z, R, Ns, tw, False, zero_upper=p == 0)
        Ns *= R
    # The split: P[k] = |E - U|^2 and P[n-k] = |E + U|^2 for each k.
    k = np.arange(n)
    pk, pn = _split_power(z[:, k], np.conj(z[:, (n - k) % n]), tw, rdt)
    half = np.concatenate([pk[:, 0::2], pn[:, :1]], axis=1)  # P[2k], and P[n] from k = 0
    # The inverse packing W[k] = (P[k] + P[n-k]) + i w^-k (P[k] - P[n-k]).
    S, D = pk + pn, pk - pn
    W = ((S + tw.imag * D) + 1j * (tw.real * D)).astype(cdt)
    Ns = 1
    for p, R in enumerate(plan):
        W = _stockham_pass(W, R, Ns, tw, True, half_out=p == len(plan) - 1)
        Ns *= R
    w = W[:, : n // 2] * rdt(1.0 / (2 * n))
    return half, np.stack([w.real, w.imag], axis=-1).reshape(B, n)


def _frame_scaled_err(got, want):
    """max |got - want| over each frame's largest |want|."""
    return float((np.abs(got - want) / np.abs(want).max(axis=-1, keepdims=True)).max())


def test_radix_plan():
    """16 16 16 at the bench frame, 16 16 8 at the flagship's, as
    csrc/ct_fused.cu's header states."""
    assert _radix_plan(4096) == [16, 16, 16]
    assert _radix_plan(2048) == [16, 16, 8]
    assert _radix_plan(8192) == [16, 16, 16, 2]
    assert _radix_plan(128) == [16, 8]


@pytest.mark.parametrize("n", [1 << k for k in range(7, 14)])
def test_kernel_model_matches_plain_f64(n):
    """Float64, at every n the gate admits in either dtype: within 1e-12 of
    each frame's largest value."""
    x = _frames(n, 3, seed=5)
    half, ac = _model_ct_fused(x)
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    assert half.shape == hp.shape and ac.shape == ap.shape
    assert _frame_scaled_err(half, hp.numpy()) <= 1e-12
    assert _frame_scaled_err(ac, ap.numpy()) <= 1e-12


@pytest.mark.parametrize("n", [2048, 4096])
def test_kernel_model_matches_plain_f32(n):
    """Float32 arithmetic throughout, at the flagship and bench frames:
    within CT_FUSED_F32_TOL of each frame's largest value, the card's
    tolerance for the kernel."""
    x = _frames(n, 4, seed=9).astype(np.float32)
    half, ac = _model_ct_fused(x)
    assert half.dtype == np.float32 and ac.dtype == np.float32
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    assert _frame_scaled_err(half, hp.numpy()) <= CT_FUSED_F32_TOL
    assert _frame_scaled_err(ac, ap.numpy()) <= CT_FUSED_F32_TOL


def _fft_reference(x):
    """np.fft's (half, lags) of (B, n) frames, in float64."""
    n = x.shape[-1]
    p = np.abs(np.fft.rfft(x.astype(np.float64), 2 * n)) ** 2
    return p[:, ::2], np.fft.irfft(p, 2 * n)[:, :n]


@pytest.mark.parametrize("n, cluster", [(256, 2), (256, 4), (2048, 4), (8192, 2), (16384, 2), (16384, 4)])
def test_cluster_model_matches_fft_f64(n, cluster):
    """The cluster's split (csrc/ct_fused.cu's ct_fused_cluster_kernel) in
    float64 against np.fft, within 1e-12 of each frame's largest value:
    the kernel's clusters (16,384 float32 over 2 blocks, 8,192 and 16,384
    float64 over 2 and 4) and both cluster sizes at small n, where every
    class holds few points."""
    x = _frames(n, 3, seed=11)
    half, ac = _model_ct_fused(x, cluster)
    hf, af = _fft_reference(x)
    assert half.shape == hf.shape and ac.shape == af.shape
    assert _frame_scaled_err(half, hf) <= 1e-12
    assert _frame_scaled_err(ac, af) <= 1e-12


def test_cluster_model_matches_plain_f32():
    """Float32 arithmetic throughout at 16,384 over 2 blocks, float32's
    cluster: within CT_FUSED_F32_TOL of each frame's largest value of the
    plain version."""
    n = 16384
    assert ct_fused.ct_fused_cluster(n, torch.float32) == 2
    x = _frames(n, 3, seed=9).astype(np.float32)
    half, ac = _model_ct_fused(x, 2)
    assert half.dtype == np.float32 and ac.dtype == np.float32
    hp, ap = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x), 2 * n)
    assert _frame_scaled_err(half, hp.numpy()) <= CT_FUSED_F32_TOL
    assert _frame_scaled_err(ac, ap.numpy()) <= CT_FUSED_F32_TOL
