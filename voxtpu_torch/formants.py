"""McCandless formant slot tracking + the find_formants pipeline.

Port of voxtpu.formants (reference: `EstimateFormants`, spectrum.rs:225-334;
`FormantExtractor`, spectrum.rs:336-369; `find_formants`, lib.rs:40-116).
Everything upstream of the tracker is frame-parallel: resample -> Hann
window -> Burg LPC (kernel B) -> monic polynomial -> roots (kernel C) -> f32
polish -> resonances. The tracker's frame-to-frame carry runs in kernel D
(voxtpu_torch.ops.formant_scan) on the card, and as a Python loop of
`estimate_formants_step` on the CPU.
"""

from __future__ import annotations

import math

import torch

from voxtpu_torch.cplx import C
from voxtpu_torch.device import constant
from voxtpu_torch.lpc import burg
from voxtpu_torch.ops.formant_scan import formant_scan
from voxtpu_torch.resonance import resonances_from_roots, sort_and_pack_resonances
from voxtpu_torch.roots import find_roots, polish_roots
from voxtpu_torch.windows import hann

__all__ = [
    "MAX_RESONANCES",
    "MALE_FORMANT_ESTIMATES",
    "FEMALE_FORMANT_ESTIMATES",
    "estimate_formants_step",
    "formant_tracker",
    "formant_tracker_batched",
    "formant_candidates",
    "find_formants",
    "resample_linear",
    "resample_sinc",
]

NSLOTS = 6  # FormantSlots = [Option<Resonance>; 6] (spectrum.rs:228)
MAX_RESONANCES = 32  # lib.rs:26
MALE_FORMANT_ESTIMATES = (320.0, 1440.0, 2760.0, 3200.0)  # lib.rs:27
FEMALE_FORMANT_ESTIMATES = (480.0, 1760.0, 3200.0, 3520.0)  # lib.rs:28


def _set_slot(arr: torch.Tensor, j: int, value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """arr[..., j] = value where mask (batched, out of place)."""
    at_j = torch.arange(arr.shape[-1], device=arr.device) == j
    return torch.where(at_j & mask[..., None], value[..., None], arr)


def estimate_formants_step(
    est_freq: torch.Tensor, est_bw: torch.Tensor, res_freq: torch.Tensor, res_bw: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One McCandless update (spectrum.rs:232-333), batched over leading axes.

    est_*: (..., L) previous estimates; res_*: (..., R) this frame's whole
    resonance buffer, zero tail included (zero entries take part in the
    nearest match and the step-4 fills, as in the reference). Returns the
    updated (est_freq, est_bw).
    """
    L = est_freq.shape[-1]
    R = res_freq.shape[-1]
    batch = est_freq.shape[:-1]
    dev = est_freq.device
    ns = min(L, NSLOTS)
    slot_idx = torch.arange(NSLOTS, device=dev)

    # --- Step 2: nearest resonance per estimate slot (first wins on ties).
    dist = torch.abs(res_freq[..., None, :] - est_freq[..., :ns, None])  # (..., ns, R)
    nearest = torch.argmin(dist, dim=-1)
    sf = torch.gather(res_freq, -1, nearest)
    sb = torch.gather(res_bw, -1, nearest)
    if ns < NSLOTS:
        sf = torch.nn.functional.pad(sf, (0, NSLOTS - ns))
        sb = torch.nn.functional.pad(sb, (0, NSLOTS - ns))
    sv = torch.broadcast_to(slot_idx < ns, batch + (NSLOTS,))

    # --- Step 3: dedup over the 6 slots with a moving pointer w to the
    # previous surviving slot (spectrum.rs:250-272).
    w = torch.zeros(batch, dtype=torch.int64, device=dev)
    unassigned = torch.zeros(batch, dtype=torch.bool, device=dev)
    for r in range(1, NSLOTS):
        vr_f, vr_b, vr_valid = sf[..., r], sb[..., r], sv[..., r]
        sw_f = torch.gather(sf, -1, w[..., None])[..., 0]
        sw_b = torch.gather(sb, -1, w[..., None])[..., 0]
        same = vr_valid & (vr_f == sw_f) & (vr_b == sw_b)
        est_r = est_freq[..., min(r, L - 1)]
        est_w = torch.gather(est_freq, -1, torch.clamp(w, max=L - 1)[..., None])[..., 0]
        closer_r = torch.abs(vr_f - est_r) < torch.abs(vr_f - est_w)
        inval_w = same & closer_r
        inval_r = same & ~closer_r
        sv = torch.where((slot_idx == w[..., None]) & inval_w[..., None], False, sv)
        sv = _set_slot(sv, r, torch.zeros_like(inval_r), inval_r)
        unassigned = unassigned | same
        w = torch.where(inval_w | (~same & vr_valid), r, w)

    # --- Step 4: fill empty slots with unassigned peaks (spectrum.rs:274-310);
    # iterations j >= 6 change nothing.
    true_ = torch.ones(batch, dtype=torch.bool, device=dev)
    for j in range(min(R, NSLOTS)):
        pf, pb = res_freq[..., j], res_bw[..., j]
        contains = torch.any(sv & (sf == pf[..., None]) & (sb == pb[..., None]), dim=-1)
        can = unassigned & ~contains

        b1 = can & ~sv[..., j]
        sf = _set_slot(sf, j, pf, b1)
        sb = _set_slot(sb, j, pb, b1)
        sv = _set_slot(sv, j, true_, b1)
        can = can & ~b1

        if j > 0:
            b2 = can & ~sv[..., j - 1]  # swap(j, j-1), then slots[j] = peak
            oldf, oldb, oldv = sf[..., j], sb[..., j], sv[..., j]
            sf = _set_slot(_set_slot(sf, j - 1, oldf, b2), j, pf, b2)
            sb = _set_slot(_set_slot(sb, j - 1, oldb, b2), j, pb, b2)
            sv = _set_slot(_set_slot(sv, j - 1, oldv, b2), j, true_, b2)
            can = can & ~b2

        if j + 1 < NSLOTS:
            b3 = can & ~sv[..., j + 1]
            oldf, oldb, oldv = sf[..., j], sb[..., j], sv[..., j]
            sf = _set_slot(_set_slot(sf, j + 1, oldf, b3), j, pf, b3)
            sb = _set_slot(_set_slot(sb, j + 1, oldb, b3), j, pb, b3)
            sv = _set_slot(_set_slot(sv, j + 1, oldv, b3), j, true_, b3)

    # --- Step 5: stable sort, invalid slots first, then ascending frequency
    # (spectrum.rs:312-324).
    order = torch.sort(torch.where(sv, sf, -math.inf), dim=-1, stable=True).indices
    sf = torch.gather(sf, -1, order)
    sb = torch.gather(sb, -1, order)
    sv = torch.gather(sv, -1, order)

    # --- Write-back: winners (valid, freq > 0) overwrite the leading
    # estimates in order (spectrum.rs:326-332).
    winner = sv & (sf > 0)
    worder = torch.sort((~winner).to(torch.uint8), dim=-1, stable=True).indices
    wf = torch.gather(sf, -1, worder)
    wb = torch.gather(sb, -1, worder)
    nw = torch.sum(winner, dim=-1)
    if L > NSLOTS:
        wf = torch.nn.functional.pad(wf, (0, L - NSLOTS))
        wb = torch.nn.functional.pad(wb, (0, L - NSLOTS))
    take = torch.arange(L, device=dev) < nw[..., None]
    return torch.where(take, wf[..., :L], est_freq), torch.where(take, wb[..., :L], est_bw)


def formant_tracker(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track one recording's (F, R) resonances from the (L,) starting
    estimates (FormantExtractor, spectrum.rs:336-369): the per-frame
    estimate snapshots, (F, L) x 2. Kernel D on the card."""
    return formant_scan(res_freq, res_bw, est_freq, est_bw)


def formant_tracker_batched(
    res_freq: torch.Tensor, res_bw: torch.Tensor, est_freq: torch.Tensor, est_bw: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Track a batch of recordings: res_* (files, F, R) -> (files, F, L).
    Each recording's carry starts from the seed estimates (spectrum.rs:
    336-341). The files fold into the frame axis and kernel D resets the
    carry every F frames, so the whole batch is one launch."""
    files, F, R = res_freq.shape
    freqs, bws = formant_scan(
        res_freq.reshape(files * F, R), res_bw.reshape(files * F, R), est_freq, est_bw, file_len=F,
    )
    L = freqs.shape[-1]
    return freqs.reshape(files, F, L), bws.reshape(files, F, L)


def resample_linear(x: torch.Tensor, ratio: float, out_len: int) -> torch.Tensor:
    """Linear-interpolation resampling (lib.rs:57-64): output k sits at input
    position k/ratio; positions past the end interpolate toward 0."""
    pos = torch.arange(out_len, dtype=x.dtype, device=x.device) / ratio
    i0 = torch.floor(pos).long()
    frac = pos - i0.to(x.dtype)
    xp = torch.nn.functional.pad(x, (0, 2))
    left = torch.index_select(xp, -1, i0)
    right = torch.index_select(xp, -1, i0 + 1)
    return left + (right - left) * frac


def resample_sinc(x: torch.Tensor, ratio: float, out_len: int, depth: int = 50,
                  chunk: int = 65536) -> torch.Tensor:
    """Bandlimited windowed-sinc resampling of a 1-D signal (voxtpu.formants.
    resample_sinc; the reference example's commented-out `Sinc` variant,
    examples/formant_extraction/src/main.rs:48-49). Output k sits at source
    position k/ratio and is a Hann-windowed sinc sum over `depth` taps a
    side, cut off at the lower of the two Nyquist frequencies, so
    downsampling anti-aliases.

    Outputs are computed `chunk` at a time: the (outputs, 2 depth) tap
    table of a whole recording would not fit on the card (357 s at 44.1 kHz
    is 1.6 G taps). Each output's sum is the same in any chunking."""
    if x.dim() != 1:
        raise ValueError("resample_sinc expects a 1-D signal")
    n = x.shape[-1]
    dt, dev = x.dtype, x.device
    r = torch.tensor(ratio, dtype=dt, device=dev)
    cutoff = torch.minimum(r, torch.tensor(1.0, dtype=dt, device=dev))  # <1 on downsample
    m = torch.arange(-depth + 1, depth + 1, device=dev)
    out = []
    for k0 in range(0, out_len, chunk):
        pos = torch.arange(k0, min(k0 + chunk, out_len), dtype=dt, device=dev) / r
        idx = torch.floor(pos).long()[:, None] + m[None, :]  # (outputs, 2 depth)
        valid = (idx >= 0) & (idx < n)
        xi = x[torch.clamp(idx, 0, n - 1)]
        d = pos[:, None] - idx.to(dt)  # tap offset in source samples
        ds = d * cutoff  # sinc bandwidth = cutoff * source Nyquist
        sinc = torch.where(ds == 0.0, 1.0, torch.sin(math.pi * ds) / (math.pi * ds))
        hann_w = torch.where(torch.abs(d) < depth, 0.5 + 0.5 * torch.cos(math.pi * d / depth), 0.0)
        taps = torch.where(valid, xi * sinc * hann_w, 0.0)
        out.append(cutoff * torch.sum(taps, dim=-1))
    return torch.cat(out).to(dt) if out else x.new_zeros(0)


def formant_candidates(
    frames: torch.Tensor,
    sample_rate: float,
    n_coeffs: int,
    resample_ratio: float = 1.0,
    max_resonances: int = MAX_RESONANCES,
    polish: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The frame-parallel half of find_formants (lib.rs:40-110): resample ->
    Hann window -> Burg LPC -> reversed monic polynomial -> roots -> sorted
    resonance buffer. polish: in float32, refine the roots against the
    undeflated polynomial (`roots.polish_roots`); float64 never polishes.

    Returns (rfreq (F, R), rbw (F, R), status (F,))."""
    if frames.dim() == 1:
        frames = frames[None]
    F, n = frames.shape
    dt, dev = frames.dtype, frames.device
    if resample_ratio != 1.0:
        out_len = int(math.ceil(resample_ratio * n))
        buf = resample_linear(frames, resample_ratio, out_len)
    else:
        out_len = n
        buf = frames
    buf = buf * constant(hann, out_len, dtype=dt, device=dev)

    coeffs, status = burg(buf, n_coeffs)
    # index k holds the coefficient of z^k; the top coefficient is 1 (lib.rs:76-91)
    poly_re = torch.cat([coeffs.flip(-1), torch.ones((F, 1), dtype=dt, device=dev)], dim=-1)
    poly = C(poly_re, torch.zeros_like(poly_re))

    roots, _count, rstatus = find_roots(poly)
    status = status | rstatus
    if polish and dt == torch.float32:
        roots = polish_roots(poly, roots)

    rfreq, rbw, valid = resonances_from_roots(roots, sample_rate, require_im_positive=True)
    rfreq, rbw = sort_and_pack_resonances(rfreq, rbw, valid, max_resonances)
    return rfreq, rbw, status


def find_formants(
    frames: torch.Tensor,
    sample_rate: float,
    n_coeffs: int,
    resample_ratio: float = 1.0,
    estimates=MALE_FORMANT_ESTIMATES,
    estimate_bandwidth: float = 1.0,
    estimate_bws=None,
    max_resonances: int = MAX_RESONANCES,
    polish: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full formant pipeline over one recording's (F, n) rectangular frames
    (lib.rs:40-116): returns per-frame tracked (freqs (F, L), bws (F, L),
    status (F,)). estimates/estimate_bws may be tensors (a carried state)."""
    rfreq, rbw, status = formant_candidates(
        frames, sample_rate, n_coeffs, resample_ratio=resample_ratio,
        max_resonances=max_resonances, polish=polish,
    )
    dt, dev = rfreq.dtype, rfreq.device
    est_f = torch.as_tensor(estimates, dtype=dt, device=dev)
    if estimate_bws is not None:
        est_b = torch.as_tensor(estimate_bws, dtype=dt, device=dev)
    else:
        est_b = torch.full_like(est_f, estimate_bandwidth)
    freqs, bws = formant_tracker(rfreq, rbw, est_f, est_b)
    return freqs, bws, status
