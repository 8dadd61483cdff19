"""Kernel A: Brent maximization of the windowed-sinc interpolant, per pitch
candidate (csrc/refine.cu; replaces voxtpu/ops/refine_pallas.py's
`brent_refine_pallas`).

`refine_plain` is the PyTorch version: `voxtpu.sinc.brent_maximize_sinc`
transcribed over (B, C) lanes on `voxtpu_torch.sinc._WindowEval`.
`refine` runs it for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import math

import torch

from voxtpu_torch.ops import kernels

__all__ = ["refine_plain", "refine"]

_GOLDEN = 1.0 - 0.6180339887498948482045868343656381177203091798057628621
# Lanes x taps per chunk of the plain version's gathers, to bound its memory
# at full size (35,689 frames x 32 candidates x 739 taps would need tens of
# GB at once).
_PLAIN_CHUNK_ELEMS = 1 << 24


def _brent(f, x0: torch.Tensor, valid: torch.Tensor, iters: int, tol: float):
    """brent_maximize (periodic.rs:103-188) over lanes with masked updates:
    converged and masked-off lanes freeze; the loop runs while a lane is live."""
    eps = torch.finfo(x0.dtype).eps
    sqrt_eps = math.sqrt(eps)
    a = x0 - 1.0
    b = x0 + 1.0
    v = a + _GOLDEN * (b - a)
    fv = f(v)
    x, w, fx, fw = v, v, fv, fv
    done = ~valid
    for _ in range(iters):
        if bool(done.all()):
            break
        rng = b - a
        middle = (a + b) * 0.5
        tol_act = sqrt_eps * torch.abs(x) + tol / 3.0
        done = done | (torch.abs(x - middle) + rng * 0.5 <= 2.0 * tol_act)

        new_step = torch.where(x < middle, _GOLDEN * (b - x), _GOLDEN * (a - x))
        t_ = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * t_
        q = 2.0 * q - t_  # sic (periodic.rs:140)
        p = torch.where(q > 0.0, -p, p)
        q = torch.where(q > 0.0, q, -q)
        para_ok = (
            (torch.abs(x - w) >= tol_act)
            & (torch.abs(p) < torch.abs(new_step * q))
            & (p > q * (a - x + 2.0 * tol_act))
            & (p < q * (b - x - 2.0 * tol_act))
        )
        new_step = torch.where(para_ok, p / torch.where(q == 0.0, 1.0, q), new_step)
        new_step = torch.where(
            torch.abs(new_step) < tol_act, torch.where(new_step > 0.0, tol_act, -tol_act), new_step
        )

        t = x + new_step
        ft = f(t)

        better = ft <= fx
        keep_w = (ft <= fw) | (torch.abs(w - x) < eps)
        keep_v = (ft <= fv) | (torch.abs(v - x) < eps) | (torch.abs(v - w) < eps)
        na = torch.where(better, torch.where(t < x, a, x), torch.where(t < x, t, a))
        nb = torch.where(better, torch.where(t < x, x, b), torch.where(t < x, b, t))
        nv = torch.where(better, w, torch.where(keep_w, w, torch.where(keep_v, t, v)))
        nfv = torch.where(better, fw, torch.where(keep_w, fw, torch.where(keep_v, ft, fv)))
        nw = torch.where(better, x, torch.where(keep_w, t, w))
        nfw = torch.where(better, fx, torch.where(keep_w, ft, fw))
        nx = torch.where(better, t, x)
        nfx = torch.where(better, ft, fx)

        upd = ~done
        a, b = torch.where(upd, na, a), torch.where(upd, nb, b)
        x, w, v = torch.where(upd, nx, x), torch.where(upd, nw, w), torch.where(upd, nv, v)
        fx, fw, fv = torch.where(upd, nfx, fx), torch.where(upd, nfw, fw), torch.where(upd, nfv, fv)
    return x, fx


def refine_plain(
    y: torch.Tensor, x0: torch.Tensor, valid: torch.Tensor, offset: int, max_depth: int,
    T: int, iters: int = 60, tol: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brent-maximize the sinc interpolant of each lag row y (B, L) on
    (x0 - 1, x0 + 1) for every lane of x0 (B, C). T is the static tap bound
    (`sinc._max_effective_depth`). Masked-off lanes return (v0, f(v0)).
    iters=0 evaluates only: (x0, f(x0)). Rows run in chunks; lanes are
    independent, so chunking changes no result."""
    from voxtpu_torch.sinc import _WindowEval

    B, C = x0.shape
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, C * (T + 1)))
    xs, fs = [], []
    for r0 in range(0, B, rows):
        yc, xc, vc = y[r0 : r0 + rows], x0[r0 : r0 + rows], valid[r0 : r0 + rows]
        f = _WindowEval(yc, offset, xc, max_depth, T + 1)
        if iters == 0:
            xs.append(xc.clone())
            fs.append(f(xc))
        else:
            x, fx = _brent(f, xc, vc, iters, tol)
            xs.append(x)
            fs.append(fx)
    return torch.cat(xs), torch.cat(fs)


def refine(
    y: torch.Tensor, x0: torch.Tensor, valid: torch.Tensor, offset: int, max_depth: int,
    T: int, iters: int = 60, tol: float = 1e-10,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`refine_plain` for CPU tensors; on the card, one thread per candidate
    of csrc/refine.cu."""
    if kernels.on_cpu(y, x0, valid):
        return refine_plain(y, x0, valid, offset, max_depth, T, iters=iters, tol=tol)
    if y.dim() != 2 or x0.dim() != 2 or x0.shape[0] != y.shape[0] or valid.shape != x0.shape:
        raise ValueError(f"refine: y (B, L), x0 and valid (B, C); got {y.shape}, {x0.shape}, {valid.shape}")
    if x0.dtype != y.dtype or valid.dtype != torch.bool:
        raise TypeError("refine: x0 must have y's dtype and valid must be bool")
    B, L = y.shape
    C = x0.shape[1]
    y, x0, valid = y.contiguous(), x0.contiguous(), valid.contiguous()
    x_out = torch.empty_like(x0)
    fx_out = torch.empty_like(x0)
    kernels.launch(
        "vt_refine", y.dtype, y, x0, valid, x_out, fx_out,
        B, C, L, int(offset), int(max_depth), int(T), int(iters), float(tol),
    )
    refine.launches += 1
    return x_out, fx_out


refine.launches = 0
