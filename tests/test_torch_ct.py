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
    voxtpu's: n = 96, 300, 2205 take the chain for the lags alone (nfft !=
    2n), 512 for both outputs."""
    x = _frames(n, 3, 5, dtype)
    got = autocorr.autocorrelate(torch.as_tensor(x), backend="ct")
    want = jac.autocorrelate(jnp.asarray(x), backend="ct")
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    _close_to_scale(got.numpy(), want, tol)
    gh, ga = autocorr.power_and_autocorrelate(torch.as_tensor(x), n_coeffs=n // 3, backend="ct")
    wh, wa = jac.power_and_autocorrelate(jnp.asarray(x), n_coeffs=n // 3, backend="ct")
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
    exactly where E's own gate admits the shape (MAX_N, tests/
    test_torch_ct_fused.py) and "fft" elsewhere."""
    for n, nfft in _GRID:
        for name in ("fft", "ct", "ct_fused_x3"):
            got = autocorr._backend(name, n, nfft, dtype, half=half)
            assert got == _jax_branch(name, n, nfft, half), (name, n, nfft, dtype, half)
        e = "ct_fused" if ct_fused.ct_fused_supported(n, nfft, dtype) else "fft"
        assert autocorr._backend("ct_fused", n, nfft, dtype, half=half) == e
        assert autocorr._backend(None, n, nfft, dtype, half=half) == e


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
    """kMaxN is the gate's largest n, and the launcher's shared memory
    (kLd floats a row: the frame and the lag accumulator, n/128 rows each,
    and a slab's three kSlab-row tensors) stays within a block's 227 KB at
    every n the gate admits."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxN") == ct_x3._MAX_N == max(n for n in range(1, 24000) if ct_x3.ct_x3_supported(n, 2 * n))
    assert "sizeof(float) * kLd * (2 * rows + 3 * kSlab)" in src

    def smem(n):
        return 4 * const("kLd") * (2 * (n // 128) + 3 * const("kSlab"))

    assert smem(4096) == 84480 and smem(20608) == 220704 <= ct_fused.SMEM_LIMIT
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


def test_device_table_layout():
    """The tables the kernel reads, built on the CPU: the hi and lo parts
    of each product's operand add up to the float32 table within bfloat16's
    second rounding, -s2 and -sc are the negated parts, the right operands
    sit in column pairs, and c1's odd rows of x (n = 384) are padded. hi +
    lo keeps about 16 bits of each value: within 2^-17 of it."""
    n = 384
    bf, f32 = ct_x3._device_tables(n, 2 * n, torch.device("cpu"))
    N1, rows, rows_p = 6, 3, 4
    k1, r, l2 = np.arange(N1), np.arange(128), np.arange(rows)
    t = {"c1": np.cos(2 * np.pi * np.outer(k1, l2) / N1),  # (k1, n1)
         "s2": np.sin(-2 * np.pi * np.outer(r, r) / 128),  # (n2, k2)
         "ts": np.sin(-2 * np.pi * np.outer(k1, r) / (2 * n)),  # (k1, n2)
         "sc": np.sin(2 * np.pi * np.outer(l2, k1) / N1)}  # (l2, k1)
    a, b, c = N1 * rows_p, 128 * 128, rows * N1
    assert bf.dtype == torch.bfloat16 and bf.numel() == 4 * a + 10 * b + 4 * c
    assert f32.numel() == 4 * N1 * 128
    v = bf.float()
    c1 = (v[:a] + v[a:2 * a]).reshape(N1, rows_p)
    np.testing.assert_allclose(c1[:, :rows].numpy(), t["c1"], atol=2 ** -17)
    assert torch.all(c1[:, rows:] == 0)
    ns2h = v[4 * a + 4 * b: 4 * a + 5 * b].reshape(64, 128, 2)
    assert torch.equal(ns2h, -v[4 * a + 2 * b: 4 * a + 3 * b].reshape(64, 128, 2))
    np.testing.assert_allclose(ns2h[3, 7, 1].item(), -t["s2"][7, 7], atol=4e-3)
    nsc = v[4 * a + 10 * b + 2 * c:].reshape(2, rows, N1).sum(0)
    np.testing.assert_allclose(nsc.numpy(), -t["sc"], atol=2 ** -17)
    np.testing.assert_allclose(f32[N1 * 128: 2 * N1 * 128].reshape(N1, 128).numpy(), t["ts"], atol=1e-7)
