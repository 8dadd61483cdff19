"""Kernel B's order of operations (csrc/burg.cu) modelled in NumPy and held
to `burg_plain` on the CPU, and the launch rule that the wrapper mirrors.

The kernel runs one block a frame: thread t holds pairs [t c, t c + c) of
(b1, b2), in registers or, for long frames, in shared memory or (longer
still) in device memory. Each order,
every thread sums its live pairs in ascending k in double (fused
multiply-adds), a 5-step xor butterfly adds each warp's 32 partials, every
thread adds the warps' partials in warp order and computes the reflection
coefficient, and each thread updates its pairs, the last from its
neighbour's first pair. `_model_burg` follows those steps for a launch
(threads, c). A float32 value's products are exact in double, so NumPy's
multiply-then-add is the kernel's FMA there; for float64 frames the model
rounds twice where the kernel's FMA rounds once, inside the float64
tolerance. The model is held to `burg_plain` at chip_smoke.py's
tolerances (float32 rtol 1e-4 / atol 1e-5, float64 1e-10 / 1e-12), with
the status equal, up to order 127, where warp 0 keeps 4 coefficients a
lane. `burg_plain` is held to voxtpu's Burg (`voxtpu.lpc.burg`, jnp) at
orders 40 and 127 in float64 at the same tolerance, and runs any order
on the CPU, where the card stops at 127 as voxtpu's Pallas kernel does.
"""

import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from voxtpu.lpc import burg as jax_burg

from voxtpu_torch.io_wav import read_wav
from voxtpu_torch.ops import burg as B
from voxtpu_torch.windows import hann

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "sample-two_vowels.wav")
CU = Path(__file__).resolve().parent.parent / "voxtpu_torch" / "csrc" / "burg.cu"
LANES = 32
TOL = {np.float32: (1e-4, 1e-5), np.float64: (1e-10, 1e-12)}
DTYPES = {np.float32: torch.float32, np.float64: torch.float64}


def _model_burg(x: np.ndarray, order: int, threads: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """burg_kernel in NumPy for (R, N) frames and one launch: (coeffs, status)."""
    dt = x.dtype.type
    R, N = x.shape
    npairs = N - 1
    W = threads // LANES
    k = np.arange(threads * width).reshape(threads, width)
    b1 = np.zeros((R, threads * width), dt)
    b2 = np.zeros_like(b1)
    b1[:, :npairs] = x[:, :npairs]
    b2[:, :npairs] = x[:, 1:]
    b1, b2 = b1.reshape(R, threads, width), b2.reshape(R, threads, width)

    def partials(m):
        # each thread over its live pairs in ascending k: fma(u, v, num),
        # fma(u, u, den), fma(v, v, den)
        num = np.zeros((R, threads))
        den = np.zeros((R, threads))
        for j in range(width):
            live = k[:, j] < m
            u, v = b1[:, :, j].astype(np.float64), b2[:, :, j].astype(np.float64)
            num = np.where(live, num + u * v, num)
            den = np.where(live, (den + u * u) + v * v, den)
        return num, den

    def block_sum(p):
        # the xor butterfly leaves the same bits in every lane; then the
        # warps' partials in warp order
        p = p.reshape(R, W, LANES)
        for off in (16, 8, 4, 2, 1):
            p = p + p[:, :, np.arange(LANES) ^ off]
        assert np.all(p.view(np.uint64) == p[:, :, :1].view(np.uint64))
        total = p[:, 0, 0]
        for w in range(1, W):
            total = total + p[:, w, 0]
        return total

    a = np.zeros((R, 128), dt)
    bad = np.zeros(R, bool)
    num, den = partials(npairs)
    for i in range(1, order + 1):
        tn, td = block_sum(num), block_sum(den)
        bad_i = td <= 0
        bad |= bad_i
        with np.errstate(invalid="ignore", divide="ignore"):
            ci = (2.0 * tn / np.where(bad_i, 1.0, td)).astype(dt)
        head = a[:, : i - 1] - ci[:, None] * a[:, : i - 1][:, ::-1]
        a[:, : i - 1] = head
        a[:, i - 1] = ci
        if i == order:
            break
        # the neighbour's first pair before the update (0 past the last thread)
        n1 = np.concatenate([b1[:, 1:, :1], np.zeros((R, 1, 1), dt)], axis=1)
        n2 = np.concatenate([b2[:, 1:, :1], np.zeros((R, 1, 1), dt)], axis=1)
        nxt1 = np.concatenate([b1[:, :, 1:], n1], axis=2)
        nxt2 = np.concatenate([b2[:, :, 1:], n2], axis=2)
        c = ci[:, None, None]
        b1, b2 = b1 - c * b2, nxt2 - c * nxt1
        num, den = partials(N - i - 1)
    return -a[:, :order], np.where(bad, 1, 0).astype(np.int32)


def _check(x: np.ndarray, order: int, config=None, coeffs: bool = True) -> None:
    config = config or B.launch_config(x.shape[1], DTYPES[x.dtype.type])
    cm, sm = _model_burg(x, order, config.threads, config.width)
    cp, sp = (t.numpy() for t in B.burg_plain(torch.as_tensor(x), order))
    np.testing.assert_array_equal(sm, sp)
    if coeffs:
        rtol, atol = TOL[x.dtype.type]
        np.testing.assert_allclose(cm, cp, rtol=rtol, atol=atol)


def _frames(n: int, rows: int, dt, noise: float = 0.0) -> np.ndarray:
    """`rows` Hann-windowed frames of n samples spread over the recording
    (tiled where n asks for more), plus seeded noise."""
    x = np.asarray(read_wav(FIXTURE).samples, dtype=np.float64)
    x = np.tile(x, -(-2 * n // len(x)) + 1)
    starts = np.linspace(0, len(x) - n, rows).astype(int)
    fr = np.stack([x[s : s + n] for s in starts])
    fr = fr + noise * np.random.default_rng(7).standard_normal(fr.shape)
    return (fr * hann(n)).astype(dt)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("n", [2205, 4096, 2048])
def test_model_matches_plain_on_recording(n, dt):
    """The CLI default's, the bench's and the flagship's frames, order 13,
    with the launch the rule picks (registers at these shapes)."""
    assert B.launch_config(n, DTYPES[dt]).rows == "registers"
    _check(_frames(n, 4, dt), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_every_layout(dt):
    """The three launches the kernel takes for 2205-sample frames: the
    dtype's register width, the shared layout and the device layout (512
    threads of 5 pairs) give the plain version's answer."""
    x = _frames(2205, 3, dt)
    configs = [B.layout(2205, DTYPES[dt], rows) for rows in ("registers", "shared", "device")]
    assert [(c.rows, c.threads, c.width) for c in configs] == [
        ("registers", 64 if dt == np.float32 else 96, 35 if dt == np.float32 else 23), ("shared", 64, 63),
        ("device", 512, 5)]
    for config in configs:
        _check(x, 13, config)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("n,order", [(2, 1), (3, 1), (3, 2)])
def test_model_short_frames(n, order, dt):
    x = np.random.default_rng(n).standard_normal((5, n)).astype(dt)
    _check(x, order)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_at_width_edges(dt):
    """n - 1 equal to threads x c, one under and one over (the last takes
    another warp), for the CLI default's width."""
    config = B.launch_config(2205, DTYPES[dt])
    full = config.threads * config.width
    for n in (full, full + 1, full + 2):
        got = B.launch_config(n, DTYPES[dt])
        assert got.threads * got.width >= n - 1
        _check(_frames(n, 2, dt), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_past_the_switch(dt):
    """The first n whose rows go to shared memory, and the n before it."""
    t = DTYPES[dt]
    switch = next(n for n in range(7000, 20000) if B.launch_config(n, t).rows == "shared")
    assert B.launch_config(switch - 1, t).rows == "registers"
    for n in (switch - 1, switch):
        _check(_frames(n, 2, dt, noise=0.1), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_past_the_device_switch(dt):
    """The first n whose rows go to device memory, and the n before it (the
    shared layout's largest): 512 threads of 57 pairs in float32, 29 in
    float64, the last warp partly live."""
    t = DTYPES[dt]
    switch = 28968 if dt == np.float32 else 14498
    assert B.launch_config(switch - 1, t).rows == "shared"
    assert B.launch_config(switch, t) == ("device", 512, 57 if dt == np.float32 else 29)
    for n in (switch - 1, switch):
        _check(_frames(n, 2, dt, noise=0.1), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("order", [1, 64, 127])
def test_model_orders(order, dt):
    _check(_frames(2205, 2, dt), order)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_zero_frame_sets_status(dt):
    x = _frames(512, 3, dt)
    x[1] = 0
    cm, sm = _model_burg(x, 13, *B.launch_config(512, DTYPES[dt])[1:])
    assert sm.tolist() == [0, 1, 0] and np.all(cm[1] == 0)
    _check(x, 13)


@pytest.mark.parametrize("n,order", [(5, 6), (5, 8), (2, 3)])
def test_model_order_above_frame_status(n, order):
    """Order above the frame: both flag the frame (an order with no live
    pair sums 0). Only the status is compared: the plain version, like
    voxtpu's jnp path, slices b1[:m] with a negative m there, while the
    kernel, like voxtpu's Pallas kernel, masks k < m; voxtpu's two backends
    give coefficients up to 0.88 apart on such frames, which are flagged
    best-effort values."""
    x = np.random.default_rng(order).standard_normal((4, n))
    _check(x, order, coeffs=False)
    assert np.all(_model_burg(x, order, 32, 7)[1] == 1)


def test_launch_rule():
    """A pure function of (n, dtype) that launches every n from 2 to 2^20:
    every launch holds n - 1 pairs within the block's threads and shared
    memory; the path shapes take registers, longer frames up to 512
    threads of the dtype's width, then shared memory, in whole warps, past
    the largest frame the kernel it replaced took (each layout keeps the
    range it had: up to 28,967 float32 and 14,497 float64 samples), then
    512 threads with the rows in device memory."""
    for dt, width, largest in ((torch.float32, 35, 28967), (torch.float64, 23, 14497)):
        switch = 512 * width + 2  # the first n whose pairs exceed the registers
        seen = {}
        for n in range(2, (1 << 20) + 1):
            c = B.launch_config(n, dt)
            seen.setdefault(c.rows, [n, n])[1] = n
            assert c.threads * c.width >= n - 1
        assert seen == {"registers": [2, switch - 1], "shared": [switch, largest], "device": [largest + 1, 1 << 20]}
        for n in [*range(2, 300), 2047, 2048, 2205, 4096, switch - 2, switch - 1, switch, switch + 1, largest,
                  largest + 1, 28927, 14431, 29100, 14600, 32768, 65536, (1 << 20) - 1, 1 << 20]:
            c = B.launch_config(n, dt)
            assert c == B.launch_config(n, dt) and c == B.layout(n, dt, c.rows)
            assert c.threads <= B._MAX_THREADS and B.smem_bytes(n, dt, c) <= B._SMEM_LIMIT
            if c.rows == "device":
                assert c.threads == 512 and c.threads * c.width >= n - 1 > c.threads * (c.width - 1)
                assert B.smem_bytes(n, dt, c) == 4 * 16 * 8 + 4 * 16 * dt.itemsize  # the slots alone
            else:
                assert c.threads % 32 == 0 and c.threads * c.width >= n - 1 > c.threads * c.width - 32 * c.width
                assert c.width == (63 if c.rows == "shared" else width)
    # The kernel B replaced took 2 n values and its static shared memory
    # (1,032 bytes in float, 1,548 in double) within the 232,448 a block may
    # take: the longest frames it took are the shared layout's longest, and
    # the next lengths take the device layout.
    assert B.launch_config(29100, torch.float32) == ("device", 512, 57)
    assert B.launch_config(14600, torch.float64) == ("device", 512, 29)
    assert B.layout(29100, torch.float32, "shared") is None and B.layout(14600, torch.float64, "shared") is None
    with pytest.raises(TypeError):
        B.launch_config(2205, torch.float16)


def test_constants_mirror_cuda_source():
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxOrder") == B._MAX_ORDER == 127  # voxtpu/ops/burg_pallas.py:87-88
    assert 32 * const("kCoefRegs") > B._MAX_ORDER  # warp 0 holds every coefficient
    assert B._WIDTH == {torch.float32: const("kWidthF32"), torch.float64: const("kWidthF64")}
    assert B._SHARED_WIDTH == const("kSharedWidth")
    assert B._MAX_THREADS == const("kMaxThreads")
    assert const("kSmemLimit") == B._SMEM_LIMIT
    assert "return round16(rows * sizeof(T)) + 4 * W * sizeof(double) + 4 * W * sizeof(T);" in src
    assert ("where == kRowsShared ? 2 * static_cast<size_t>(N - 1)\n"
            "                      : where == kRowsRegisters ? static_cast<size_t>(N) : 0;") in src
    assert B.ROWS == {name: const(f"kRows{name.capitalize()}") for name in ("registers", "shared", "device")}


def test_chip_smoke_long_frames_take_their_layout():
    """chip_smoke.py's BURG_LARGE cases name the layout the rule gives them,
    and cover each layout in each dtype, the register layout at its largest
    frame included, and the device layout at 32,768 and 65,536 float32 and
    16,384 and 32,768 float64 samples."""
    from chip_smoke import BURG_LARGE

    for dname, n, _, rows in BURG_LARGE:
        assert B.launch_config(n, getattr(torch, dname)).rows == rows
    for dname, width, device in (("float32", 35, {32768, 65536}), ("float64", 23, {16384, 32768})):
        cases = {(n, rows) for d, n, _, rows in BURG_LARGE if d == dname}
        assert (512 * width + 1, "registers") in cases and any(rows == "shared" for _, rows in cases)
        assert {n for n, rows in cases if rows == "device"} == device


@pytest.mark.parametrize("order", [40, 127])
def test_plain_matches_jax_at_high_orders(order):
    """Orders the card took only up to 64 before: the plain version against
    voxtpu's jnp Burg on the recording's frames, float64."""
    x = _frames(2205, 4, np.float64)
    got, gstatus = B.burg_plain(torch.as_tensor(x), order)
    want, wstatus = jax_burg(jnp.asarray(x), order, backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(gstatus.numpy(), np.asarray(wstatus))


def test_any_order_on_cpu():
    """Above the card's 127 the CPU runs the plain version, uncounted."""
    x = torch.as_tensor(_frames(512, 2, np.float64))
    before = B.burg.launches
    got = B.burg(x, 160)
    want = B.burg_plain(x, 160)
    assert B.burg.launches == before and got[0].shape == (2, 160)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
