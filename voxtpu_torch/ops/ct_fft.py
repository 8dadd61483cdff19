"""The "ct" autocorrelation backend: the four-step Cooley-Tukey real FFT
power and its inverse cosine transform as chains of matmuls (port of
voxtpu/ops/ct_fft.py).

voxtpu computes these products as XLA matmuls outside any Pallas kernel;
here they are `torch.matmul` (cuBLAS on the card), in true float32: TF32
keeps about three decimal digits, so every entry point turns it off for
cuBLAS before its products (`device.pin_fp32_matmul`).

Layout (voxtpu's): the nfft-point transform splits as N1 x N2, N2 = 128,
x viewed (N1, N2) row-major with n = n1 N2 + n2, and the forward power
arrives PERMUTED, P[k1, k2] with k = k2 N1 + k1. Consumers never
un-permute it:
- `ct_autocorr`'s tables absorb the permutation;
- `ct_half_power` takes the even-k1 rows, which are the even nfft bins
  (j = k2 N1/2 + k1/2): the (nfft/2)-point spectrum of a zero-padded frame.

Forward: X[k2 N1 + k1] = sum_n2 W_N^{n2 k1} (sum_n1 x[n1, n2] W_N1^{n1 k1})
W_N2^{n2 k2}: stage 1 contracts n1 (only the occupied rows of the
zero-padded frame), stage 2 is the twiddle, stage 3 contracts n2.
Inverse, l = l1 + N2 l2: theta = 2 pi k l / N = a + b + c with
a = 2 pi k2 l1 / N2, b = 2 pi k1 l1 / N, c = 2 pi k1 l2 / N1;
ac[l] = (1/N) sum_k1 (Ca cb - Sa sb) cos(c) - (Ca sb + Sa cb) sin(c),
Ca/Sa = P @ cos/sin(a) contracting k2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from voxtpu_torch.device import constant, pin_fp32_matmul

__all__ = ["N2", "ct_supported", "ct_power", "ct_half_power", "ct_autocorr"]

N2 = 128  # stage-3 matmul dimension (voxtpu's lane width)


def ct_supported(nfft: int) -> bool:
    """nfft splits as N1 x 128 with even N1 (the even-k1 half spectrum):
    every power of two >= 256."""
    return nfft % N2 == 0 and (nfft // N2) % 2 == 0


@functools.lru_cache(maxsize=8)
def _fwd_tables_np(nfft: int, n: int) -> tuple:
    N1 = nfft // N2
    rows = -(-n // N2)
    w1 = -2.0 * np.pi * np.outer(np.arange(rows), np.arange(N1)) / N1  # (n1, k1)
    w2 = -2.0 * np.pi * np.outer(np.arange(N2), np.arange(N2)) / N2  # (n2, k2)
    tw = -2.0 * np.pi * np.outer(np.arange(N2), np.arange(N1)) / nfft  # (n2, k1)
    return np.cos(w1), np.sin(w1), np.cos(w2), np.sin(w2), np.cos(tw), np.sin(tw)


@functools.lru_cache(maxsize=8)
def _inv_tables_np(nfft: int, n_lags: int) -> tuple:
    N1 = nfft // N2
    L2 = -(-n_lags // N2)
    k1, k2, l1, l2 = np.arange(N1), np.arange(N2), np.arange(N2), np.arange(L2)
    a = 2 * np.pi * np.outer(k2, l1) / N2
    b = 2 * np.pi * np.outer(k1, l1) / nfft
    c = 2 * np.pi * np.outer(k1, l2) / N1
    return np.cos(a), np.sin(a), np.cos(b), np.sin(b), np.cos(c), np.sin(c)


def _fwd_table(nfft: int, n: int, i: int) -> np.ndarray:
    return _fwd_tables_np(nfft, n)[i]


def _inv_table(nfft: int, n_lags: int, i: int) -> np.ndarray:
    return _inv_tables_np(nfft, n_lags)[i]


def ct_power(x: torch.Tensor, nfft: int, mm=torch.matmul) -> torch.Tensor:
    """(B, n) real frames -> (B, N1, N2) power of rfft(x, nfft), permuted
    k = k2 N1 + k1. The zero padding is implicit: only the occupied rows of
    the (N1, N2) view are contracted. `mm` computes every product (kernel
    X3's plain version passes its three-pass one)."""
    pin_fp32_matmul()
    B, n = x.shape
    rows = -(-n // N2)
    c1, s1, c2, s2, tc, ts = (constant(_fwd_table, nfft, n, i, dtype=x.dtype, device=x.device) for i in range(6))
    if rows * N2 != n:
        x = torch.nn.functional.pad(x, (0, rows * N2 - n))
    xm = x.reshape(B, rows, N2).transpose(1, 2)  # (B, n2, n1)
    ar = mm(xm, c1)  # (B, n2, k1)
    ai = mm(xm, s1)
    br = (ar * tc - ai * ts).transpose(1, 2)  # (B, k1, n2)
    bi = (ar * ts + ai * tc).transpose(1, 2)
    xr = mm(br, c2) - mm(bi, s2)  # (B, k1, k2)
    xi = mm(br, s2) + mm(bi, c2)
    return xr * xr + xi * xi


def ct_half_power(p: torch.Tensor, n_half: int) -> torch.Tensor:
    """Natural-order half power of the (nfft/2)-point spectrum from the
    permuted (B, N1, N2) power: its even-k1 rows, j = k2 N1/2 + k1/2."""
    B = p.shape[0]
    return p[:, 0::2, :].transpose(1, 2).reshape(B, -1)[:, :n_half]


def ct_autocorr(p: torch.Tensor, n_lags: int, mm=torch.matmul) -> torch.Tensor:
    """Permuted (B, N1, N2) power -> the first n_lags natural-order lags of
    irfft(power, nfft) (the linear autocorrelation); `mm` as in `ct_power`."""
    pin_fp32_matmul()
    B, N1, _ = p.shape
    nfft = N1 * N2
    ca, sa, cb, sb, cc, sc = (constant(_inv_table, nfft, n_lags, i, dtype=p.dtype, device=p.device)
                              for i in range(6))
    Ca = mm(p, ca)  # (B, k1, l1)
    Sa = mm(p, sa)
    U = (Ca * cb - Sa * sb).transpose(1, 2)  # (B, l1, k1)
    V = (Ca * sb + Sa * cb).transpose(1, 2)
    ac = (mm(U, cc) - mm(V, sc)) / nfft  # (B, l1, l2)
    return ac.transpose(1, 2).reshape(B, -1)[:, :n_lags]
