"""Kernel E's plain version and the port's autocorrelation routing against
voxtpu on the CPU.

`ct_fused_power_ac_plain` and `power_and_autocorrelate(backend="ct_fused")`
take the same float64 frames as voxtpu's fused Pallas kernel in interpret
mode, at the cases of tests/test_autocorr.py:135-169. Tolerances are that
test's: the half power spectrum rtol 1e-9 after dividing by its largest
value (the matmul DFT and the FFT round differently near zero bins), the
lags rtol 1e-9 / atol 1e-9. The shape gate is pinned case by case, as
tests/test_large_frames.py::test_ct_fused_vmem_budget_gate pins voxtpu's.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import voxtpu.autocorr as jac
from voxtpu.ops.ct_fused_pallas import ct_fused_power_ac as jax_ct_fused_power_ac

from voxtpu_torch import autocorr
from voxtpu_torch.ops import ct_fused, kernels, viterbi

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
    (4096, 8192, torch.float64, True),  # 128 KB of shared memory
    (128, 256, torch.float64, True),  # the smallest frame
    (8192, 16384, torch.float32, True),  # 128 KB
    (8192, 16384, torch.float64, False),  # 256 KB > 227 KB
    (16384, 32768, torch.float32, False),  # 256 KB
    (64, 128, torch.float32, False),  # below 128
    (96, 192, torch.float64, False),  # not a power of two
    (1536, 3072, torch.float32, False),  # a multiple of 128, not a power of two
    (300, 1024, torch.float64, False),  # nfft != 2n
    (1024, 4096, torch.float32, False),  # nfft != 2n
    (1024, 2048, torch.float16, False),  # no half-precision kernel
])
def test_shape_gate(n, nfft, dtype, ok):
    assert ct_fused.ct_fused_supported(n, nfft, dtype) is ok


def test_shared_memory_sizer():
    """Four n values per block (the 2n-point complex frame): 64 KB in float32
    and 128 KB in float64 at the bench frame of 4096."""
    assert ct_fused.ct_fused_smem_bytes(4096, torch.float32) == 65536
    assert ct_fused.ct_fused_smem_bytes(4096, torch.float64) == 131072
    assert ct_fused.SMEM_LIMIT == 227 * 1024


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
