"""The "ct" and "ct_fused_x3" autocorrelation backends against voxtpu on
the CPU, and the routing of every backend name.

- "ct" (ops/ct_fft.py, plain matmuls) against voxtpu's "ct" chain, in
  float64 to 1e-9 of each output's largest value (the same products in
  another order) and in float32 to 2e-6 of it (float32 rounding of a
  chain of four products, measured at most 3.6e-7).
- Kernel X3's plain version against voxtpu's x3 Pallas kernel in interpret
  mode: the lags to 2e-6 of their scale (float64: equal to the last bits
  in practice; float32: at most 8.5e-7 measured), the half spectrum to
  1e-5 of its scale, because voxtpu picks the even rows with a 0/1
  product that, in three bfloat16 passes, rounds each value to hi + lo
  (about 2^-17 of it, up to 5e-6 measured); the port reads them directly.
- Both against the float64 FFT at 2e-5 of scale, tests/test_autocorr.py's
  bound for voxtpu's x3.

csrc/ct_x3.cu runs on the card only (chip_smoke.py holds it to its plain
version and to the float64 FFT at the bench shapes and at every n its
gate admits).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import voxtpu.autocorr as jac
from voxtpu.ops.ct_fft import ct_supported as jax_ct_supported
from voxtpu.ops.ct_fused_pallas import ct_fused_power_ac as jax_ct_fused_power_ac
from voxtpu.ops.ct_fused_pallas import ct_fused_supported as jax_ct_fused_supported

from voxtpu_torch import autocorr
from voxtpu_torch.ops import ct_fft, ct_fused, ct_x3, kernels

CU = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc" / "ct_x3.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, B, seed, dtype=np.float64):
    return np.random.default_rng(seed + n).standard_normal((B, n)).astype(dtype)


def _close_to_scale(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


# ---- "ct"


@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-9), (np.float32, 2e-6)])
@pytest.mark.parametrize("n", [96, 300, 512, 2205])
def test_ct_matches_jax_ct(n, dtype, tol):
    """autocorrelate and power_and_autocorrelate with backend "ct" against
    voxtpu's, under jax.jit (one program; eagerly every jnp op compiles its
    own): n = 96, 300, 2205 take the chain for the lags alone (nfft !=
    2n), 512 for both outputs."""
    x = _frames(n, 3, 5, dtype)
    got = autocorr.autocorrelate(torch.as_tensor(x), backend="ct")
    want = jax.jit(jac.autocorrelate, static_argnames="backend")(jnp.asarray(x), backend="ct")
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    _close_to_scale(got.numpy(), want, tol)
    gh, ga = autocorr.power_and_autocorrelate(torch.as_tensor(x), n_coeffs=n // 3, backend="ct")
    wh, wa = jax.jit(jac.power_and_autocorrelate, static_argnames=("n_coeffs", "backend"))(
        jnp.asarray(x), n_coeffs=n // 3, backend="ct")
    _close_to_scale(gh.numpy(), wh, tol)
    _close_to_scale(ga.numpy(), wa, tol)


def test_ct_pins_full_float32(monkeypatch):
    """The chain turns TF32 off for cuBLAS itself, whatever ran before."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    ct_fft.ct_autocorr(ct_fft.ct_power(torch.zeros((1, 256)), 512), 8)
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ---- kernel X3's plain version


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_x3_plain_matches_jax_x3_interpret(dtype):
    x = _frames(512, 3, 13, dtype)
    half, ac = ct_x3.ct_x3_power_ac_plain(torch.as_tensor(x), 1024)
    jhalf, jac_ = jax_ct_fused_power_ac(jnp.asarray(x), 1024, interpret=True, algorithm="x3")
    assert half.shape == (3, 257) and ac.shape == (3, 512) and half.dtype == ac.dtype == torch.as_tensor(x).dtype
    _close_to_scale(ac.numpy(), jac_, 2e-6)
    _close_to_scale(half.numpy(), jhalf, 1e-5)
    # Through the public entry point, with the quirk correction.
    gh, ga = autocorr.power_and_autocorrelate(torch.as_tensor(x), backend="ct_fused_x3")
    wh, wa = jac.power_and_autocorrelate(jnp.asarray(x), backend="ct_fused_x3_interpret")
    _close_to_scale(ga.numpy(), wa, 2e-6)
    _close_to_scale(gh.numpy(), wh, 1e-5)


@pytest.mark.parametrize("n", [128, 384])
def test_x3_plain_ragged_shapes_match_fft(n):
    """The smallest frame (one row of 128, N1 = 2) and a multiple of 128
    that is not a power of two (N1 = 6), both inside voxtpu's gate."""
    x = _frames(n, 2, 17, np.float32)
    half, ac = ct_x3.ct_x3_power_ac_plain(torch.as_tensor(x), 2 * n)
    fh, fa = ct_fused.ct_fused_power_ac_plain(torch.as_tensor(x.astype(np.float64)), 2 * n)
    _close_to_scale(half.numpy(), fh.numpy(), 2e-5)
    _close_to_scale(ac.numpy(), fa.numpy(), 2e-5)


@pytest.mark.parametrize("backend", ["ct", "ct_fused_x3"])
def test_matmul_backends_match_fft(backend):
    """tests/test_autocorr.py:172-190's bound for voxtpu's x3, on its
    input: float32 (3, 512) frames, both outputs to 2e-5 of scale."""
    x = np.random.default_rng(13).standard_normal((3, 512)).astype(np.float32)
    p1, a1 = autocorr.power_and_autocorrelate(torch.as_tensor(x), backend="fft")
    p2, a2 = autocorr.power_and_autocorrelate(torch.as_tensor(x), backend=backend)
    _close_to_scale(p2.numpy(), p1.numpy(), 2e-5)
    _close_to_scale(a2.numpy(), a1.numpy(), 2e-5)


# ---- routing


def _jax_branch(backend, n, nfft, half):
    """voxtpu/autocorr.py's choice for an explicit backend name (its
    power_and_autocorrelate when half, else its autocorrelate)."""
    ct_ok = jax_ct_supported(nfft) and (nfft == 2 * n or not half)
    if backend.startswith("ct_fused") and not jax_ct_fused_supported(n, nfft):
        return "ct" if ct_ok else "fft"
    if backend == "ct" and not ct_ok:
        return "fft"
    return backend


_GRID = [(n, nfft) for n in (64, 96, 128, 256, 300, 384, 512, 1536, 2205, 4096, 8192, 16384, 20480, 20608,
                             20736, 32768) for nfft in sorted({1 << (2 * n - 1).bit_length(), 2 * n})]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("half", [False, True])
def test_routing_matches_voxtpu(half, dtype):
    """For "fft", "ct" and "ct_fused_x3" the port takes voxtpu's branch on
    every (n, nfft, dtype) of the grid. "ct_fused" and None take kernel E
    exactly where E's own gate admits the shape and "fft" elsewhere; that
    is voxtpu's branch wherever voxtpu's fused gate admits the shape: on
    power-of-two frames up to 16,384, the only ones the entry points bring
    to it (nfft = next_pow2(2n)), and at nfft = 2n on the other multiples
    of 128 up to 20,608, in both dtypes."""
    for n, nfft in _GRID:
        for name in ("fft", "ct", "ct_fused_x3"):
            got = autocorr._backend(name, n, nfft, dtype, half=half)
            assert got == _jax_branch(name, n, nfft, half), (name, n, nfft, dtype, half)
        e = "ct_fused" if ct_fused.ct_fused_supported(n, nfft, dtype) else "fft"
        assert autocorr._backend("ct_fused", n, nfft, dtype, half=half) == e
        assert autocorr._backend(None, n, nfft, dtype, half=half) == e
        if jax_ct_fused_supported(n, nfft):
            assert e == _jax_branch("ct_fused", n, nfft, half) == "ct_fused", (n, nfft, dtype, half)
        elif n & (n - 1) == 0:
            assert e == "fft", (n, nfft, dtype, half)


def test_routed_requests_run_the_routed_branch():
    """An x3 request outside the gate runs "ct" (n = 300: nfft = 1024 != 2n,
    the lags alone) or "fft" (n = 64: nfft = 128 does not split), bit for
    bit; no X3 launch is counted on the CPU."""
    before = ct_x3.ct_x3_power_ac.launches
    x = torch.as_tensor(_frames(300, 2, 3))
    assert torch.equal(autocorr.autocorrelate(x, 40, backend="ct_fused_x3"), autocorr.autocorrelate(x, 40, backend="ct"))
    h1, a1 = autocorr.power_and_autocorrelate(x, backend="ct_fused_x3")
    h2, a2 = autocorr.power_and_autocorrelate(x, backend="fft")
    assert torch.equal(h1, h2) and torch.equal(a1, a2)
    y = torch.as_tensor(_frames(64, 2, 3))
    assert torch.equal(autocorr.autocorrelate(y, backend="ct_fused_x3"), autocorr.autocorrelate(y, backend="fft"))
    assert ct_x3.ct_x3_power_ac.launches == before


@pytest.mark.parametrize("backend, match", [
    ("ct_fused_interpret", "interpret-mode"), ("ct_fused_x3_interpret", "interpret-mode"),
    ("ct_x3", "unknown backend"), ("x3", "unknown backend"), ("CT", "unknown backend"),
])
def test_unknown_and_interpret_names_raise(backend, match):
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match=match):
        autocorr.autocorrelate(x, 8, backend=backend)
    with pytest.raises(ValueError, match=match):
        autocorr.power_and_autocorrelate(x, 8, backend=backend)


# ---- the gate and the source


def test_x3_gate_is_voxtpus():
    """X3 admits exactly what voxtpu's fused gate admits, in both dtypes
    alike: nfft == 2n, n a multiple of 128 up to 20,608 (its VMEM budget),
    every power of two from 128 to 16384 among them."""
    admitted = [n for n in range(1, 24000) if ct_x3.ct_x3_supported(n, 2 * n)]
    assert admitted == [n for n in range(1, 24000) if jax_ct_fused_supported(n, 2 * n)]
    assert admitted[0] == 128 and admitted[-1] == 20608 and all(n % 128 == 0 for n in admitted)
    assert {1 << k for k in range(7, 15)} <= set(admitted)
    assert not ct_x3.ct_x3_supported(4096, 16384) and not ct_x3.ct_x3_supported(300, 1024)


def test_x3_constants_mirror_the_cuda_source():
    """kMaxN is the gate's largest n; the kernel's tiling (k1 rows a tile,
    rows of x a chunk, lag rows a piece) is the wrapper's; its shared
    memory (the c2, s2 images, the power's image, the ring of x chunks and
    two stages of cc pieces: the same at every n) stays within a block's
    227 KB; and at every n the gate admits the tiles cover the N1 k1 rows,
    the chunks the n/128 rows of x, the pieces the lag rows, and the
    E(8ab) table the twiddles' indices: rows k1 < 64 tiles and l1 < 128,
    columns j < 16 forward and 8 t + j < 8 tiles in the inverse."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    admitted = [n for n in range(1, 24000) if ct_x3.ct_x3_supported(n, 2 * n)]
    assert const("kMaxN") == ct_x3._MAX_N == max(admitted)
    assert (const("kTile"), const("kChunk"), const("kPiece")) == (ct_x3._TILE, ct_x3._CHUNK, ct_x3._PIECE)
    assert "kWBytes + kPBytes + kStages * kXBytes + 2 * kCCBytes + 8 * kBars" in src
    table = 128 * 128 * 2
    smem = (4 * table + 2 * const("kTile") * 128 * 2 + const("kStages") * const("kChunk") * 128 * 4
            + 2 * 4 * const("kPiece") * const("kTile") * 2 + 8 * (const("kStages") + 5))
    assert smem == 229448 <= ct_fused.SMEM_LIMIT
    for n in admitted:
        N1, tiles, chunks, pieces, a8, b8 = ct_x3._layout(n)
        rows = n // 128
        assert N1 == 2 * rows and (tiles - 1) * 64 < N1 <= tiles * 64, n
        assert (chunks - 1) * 16 < rows <= chunks * 16 and (pieces - 1) * 32 < rows <= pieces * 32, n
        assert a8 >= max(64 * tiles, 128) and b8 >= max(8 * tiles, 16), n
    assert ct_x3._layout(4096) == (64, 1, 2, 1, 128, 16)
    assert ct_x3._layout(20608) == (322, 6, 11, 6, 384, 48)
    assert kernels.suffixes("vt_ct_x3") == ("f32",)


def test_x3_wrapper_raises_on_the_card_path(monkeypatch, tmp_path):
    """Handed tensors it would launch on, the wrapper raises ValueError for
    float64 (X3 is float32-only) and for a shape outside the gate, and
    KernelBuildError for float32 when the library cannot be built: never
    the plain version."""
    monkeypatch.setattr(kernels, "find_nvcc", lambda: None)
    monkeypatch.setattr(kernels, "library_path", lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(kernels, "on_cpu", lambda *t: False)
    kernels.library.cache_clear()
    try:
        with pytest.raises(ValueError, match="float32 only"):
            ct_x3.ct_x3_power_ac(torch.zeros((2, 256), dtype=torch.float64), 512)
        with pytest.raises(ValueError, match="unsupported shape"):
            ct_x3.ct_x3_power_ac(torch.zeros((2, 300)), 600)
        with pytest.raises(kernels.KernelBuildError):
            ct_x3.ct_x3_power_ac(torch.zeros((2, 256)), 512)
        with pytest.raises(TypeError, match="no kernel for torch.float64"):
            kernels.launch("vt_ct_x3", torch.float64, torch.zeros(1))
        assert ct_x3.ct_x3_power_ac.launches == 0
    finally:
        kernels.library.cache_clear()


def _unimage(v, R, K):
    """ct_x3._image's inverse: a (R, K) operand from its shared-memory image."""
    return v.reshape(R // 8, K // 8, 8, 8).permute(0, 2, 1, 3).reshape(R, K)


def _unfragments(v):
    """ct_x3._fragments' inverse: a (64, 16) left operand from the
    registers of 128 threads."""
    return v.reshape(4, 8, 4, 2, 2, 2).permute(0, 4, 1, 3, 2, 5).reshape(64, 16)


def test_x3_table_identities():
    """The identities that let the kernel keep one pair of 128-point tables
    and one twiddle table, at every n the gate admits: the inverse's
    cos(2 pi k2 l1 / 128) is c2 and its sin is -s2 (both symmetric), and
    its cb, sb are the forward twiddles tc and -ts, transposed."""
    for n in (n for n in range(128, 20609, 128) if ct_x3.ct_x3_supported(n, 2 * n)):
        c1, s1, c2, s2, tc, ts = ct_fft._fwd_tables_np(2 * n, n)
        ca, sa, cb, sb, cc, sc = ct_fft._inv_tables_np(2 * n, n)
        assert np.array_equal(ca, c2) and np.array_equal(sa, -s2), n
        assert np.array_equal(c2, c2.T) and np.array_equal(s2, s2.T), n
        assert np.array_equal(cb, tc.T) and np.array_equal(sb, -ts.T), n


@pytest.mark.parametrize("n", [384, 4224])
def test_device_table_layout(n):
    """The tables the kernel reads, built on the CPU and unpacked: the hi
    and lo parts of c2 and s2 (images), of c1 and s1 (register fragments
    a tile and chunk) and of cc and sc (images a tile and piece) add up to
    ct_fft's tables within bfloat16's second rounding (hi + lo keeps about
    16 bits: within 2^-17), zero where the tiles run past N1, the rows of
    x and the lag rows; the products of the twiddle factors E(8ab) E(am)
    are the forward twiddles (tc, -ts) and the inverse's (cb, sb) to
    float32 rounding. n = 384: one tile, chunk and piece; n =
    4224: 2 tiles (66 k1 rows), 3 chunks, 2 pieces."""
    bf, f32 = ct_x3._device_tables(n, 2 * n, torch.device("cpu"))
    N1, tiles, chunks, pieces, a8, b8 = ct_x3._layout(n)
    c1, s1, c2, s2, tc, ts = ct_fft._fwd_tables_np(2 * n, n)
    cc, sc, cb, sb = [ct_fft._inv_tables_np(2 * n, n)[i] for i in (4, 5, 2, 3)]
    assert bf.dtype == torch.bfloat16 and bf.numel() == 4 * 128 * 128 + tiles * chunks * 4096 + tiles * pieces * 8192
    v = bf.float()
    T = 128 * 128
    for i, m in enumerate((c2, s2)):
        got = _unimage(v[2 * i * T:(2 * i + 1) * T], 128, 128) + _unimage(v[(2 * i + 1) * T:(2 * i + 2) * T], 128, 128)
        np.testing.assert_allclose(got.numpy(), m, rtol=0, atol=2 ** -17)
    off = 4 * T
    for t in range(tiles):
        for c in range(chunks):
            part = [_unfragments(v[off + (4 * (t * chunks + c) + i) * 1024:][:1024]) for i in range(4)]
            for got, m in ((part[0] + part[1], c1.T), (part[2] + part[3], s1.T)):
                want = np.zeros((64, 16))
                blk = m[64 * t:64 * (t + 1), 16 * c:16 * (c + 1)]
                want[:blk.shape[0], :blk.shape[1]] = blk
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -17)
    off += tiles * chunks * 4096
    for t in range(tiles):
        for p in range(pieces):
            part = [_unimage(v[off + (4 * (t * pieces + p) + i) * 2048:][:2048], 32, 64).T for i in range(4)]
            for got, m in ((part[0] + part[1], cc), (part[2] + part[3], sc)):
                want = np.zeros((64, 32))
                blk = m[64 * t:64 * (t + 1), 32 * p:32 * (p + 1)]
                want[:blk.shape[0], :blk.shape[1]] = blk
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -17)
    assert f32.dtype == torch.float32 and f32.numel() == 2 * (a8 * b8 + a8 * 8)
    e8 = torch.complex(*f32[:2 * a8 * b8].reshape(a8, b8, 2).unbind(-1)).numpy()
    em = torch.complex(*f32[2 * a8 * b8:].reshape(a8, 8, 2).unbind(-1)).numpy()
    k1, m = np.arange(N1)[:, None], np.arange(128)[None, :]
    fwd = e8[k1, m // 8] * em[k1, m % 8]  # E(k1 n2), k1 rows
    np.testing.assert_allclose(fwd, tc.T - 1j * ts.T, rtol=0, atol=2e-7)
    inv = e8[m.T, k1.T // 8] * em[m.T, k1.T % 8]  # E(l1 k1), l1 rows
    np.testing.assert_allclose(inv, cb.T + 1j * sb.T, rtol=0, atol=2e-7)
