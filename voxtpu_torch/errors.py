"""Per-frame status flags.

The reference (`vox_box src/error.rs:4-16`) uses a 4-variant error enum
(`LPC`, `Pitch`, `Polynomial`, `Workspace`) returned per call. A batched
kernel cannot raise host exceptions per frame without aborting the whole batch,
so the port (like voxtpu) reports per-frame conditions through integer
status arrays using the flags below, and raises ValueError/TypeError only
for host-side misuse (bad shapes, bad configs).
"""

from __future__ import annotations

# Per-frame status bit flags (int32 arrays, one entry per frame).
OK = 0
#: Burg recursion hit `denum <= 0` (reference: spectrum.rs:123-125 -> VoxBoxError::LPC).
LPC_DENUM_NONPOS = 1 << 0
#: Polynomial had zero degree - no roots (reference: polynomial.rs:95).
POLY_ZERO_DEGREE = 1 << 1
#: Polynomial division by zero during deflation (reference: polynomial.rs:192).
POLY_DIV_ZERO = 1 << 2
#: Pitch frame produced no voiced candidates (informational; reference always
#: appends the unvoiced candidate, periodic.rs:452).
PITCH_UNVOICED_ONLY = 1 << 3
#: Frame contained non-finite samples on input.
NONFINITE_INPUT = 1 << 4


def describe(status: int) -> str:
    """Human-readable description of a status bitmask."""
    if status == OK:
        return "ok"
    parts = []
    if status & LPC_DENUM_NONPOS:
        parts.append("lpc-denum-nonpositive")
    if status & POLY_ZERO_DEGREE:
        parts.append("poly-zero-degree")
    if status & POLY_DIV_ZERO:
        parts.append("poly-div-zero")
    if status & PITCH_UNVOICED_ONLY:
        parts.append("pitch-unvoiced-only")
    if status & NONFINITE_INPUT:
        parts.append("nonfinite-input")
    return "|".join(parts)
