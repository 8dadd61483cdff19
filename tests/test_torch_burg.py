"""Kernel B's order of operations (csrc/burg.cu) modelled in NumPy and held
to `burg_plain` on the CPU, and the launch rule that the wrapper mirrors.

The kernel runs one block a frame: thread t holds pairs [t c, t c + c) of
(b1, b2), in registers or, for long frames, in shared memory, then over a
thread-block cluster of C blocks, each holding a contiguous share of the
pairs in its shared memory (thread g = r T + t of the cluster), or
(longer still) in device memory. Each order,
every thread sums its live pairs in ascending k in double (fused
multiply-adds), a 5-step xor butterfly adds each warp's 32 partials, every
thread adds the warps' partials in warp order (over a cluster: lane l of
every warp adds the partials l, l + 32, ... in block rank then warp order,
then an xor butterfly over the lanes) and computes the reflection
coefficient, and each thread updates its pairs,
the last from its neighbour's first pair (across a block boundary from
the next block's slot). `_model_burg` follows those steps for a launch
(threads, c, blocks). A float32 value's products are exact in double, so NumPy's
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

import jax
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_burg(x: np.ndarray, order: int, threads: int, width: int,
                blocks: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """burg_kernel in NumPy for (R, N) frames and one launch of `blocks`
    blocks a frame (a cluster where blocks > 1), each of `threads` threads
    holding a contiguous share of threads x width pairs: (coeffs, status)."""
    dt = x.dtype.type
    R, N = x.shape
    npairs = N - 1
    W = threads // LANES
    # pair k of thread t of block r: k = (r threads + t) width + j
    k = np.arange(blocks * threads * width).reshape(blocks, threads, width)
    b1 = np.zeros((R, blocks * threads * width), dt)
    b2 = np.zeros_like(b1)
    b1[:, :npairs] = x[:, :npairs]
    b2[:, :npairs] = x[:, 1:]
    b1, b2 = b1.reshape(R, blocks, threads, width), b2.reshape(R, blocks, threads, width)

    def partials(m):
        # each thread over its live pairs in ascending k: fma(u, v, num),
        # fma(u, u, den), fma(v, v, den)
        num = np.zeros((R, blocks, threads))
        den = np.zeros((R, blocks, threads))
        for j in range(width):
            live = k[:, :, j] < m
            u, v = b1[..., j].astype(np.float64), b2[..., j].astype(np.float64)
            num = np.where(live, num + u * v, num)
            den = np.where(live, (den + u * u) + v * v, den)
        return num, den

    def butterfly(p):
        # the xor butterfly leaves the same bits in every lane
        for off in (16, 8, 4, 2, 1):
            p = p + p[..., np.arange(LANES) ^ off]
        assert np.all(p.view(np.uint64) == p[..., :1].view(np.uint64))
        return p[..., 0]

    def block_sum(p):
        warps = butterfly(p.reshape(R, blocks, W, LANES)).reshape(R, blocks * W)  # block rank, then warp
        if blocks == 1:
            # one block: the warps' partials in warp order
            total = warps[:, 0]
            for w in range(1, W):
                total = total + warps[:, w]
            return total
        # a cluster: lane l adds partials l, l + 32, ... from 0, then the
        # butterfly over the lanes
        lanes = np.zeros((R, LANES))
        for idx in range(blocks * W):
            lanes[:, idx % LANES] = lanes[:, idx % LANES] + warps[:, idx]
        return butterfly(lanes)

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
        # the neighbour's first pair before the update: the next thread's, the
        # last thread of a block the next block's thread 0's (0 past the
        # cluster's last thread)
        n1 = np.zeros((R, blocks, threads, 1), dt)
        n2 = np.zeros_like(n1)
        n1[:, :, :-1], n2[:, :, :-1] = b1[:, :, 1:, :1], b2[:, :, 1:, :1]
        n1[:, :-1, -1], n2[:, :-1, -1] = b1[:, 1:, 0, :1], b2[:, 1:, 0, :1]
        nxt1 = np.concatenate([b1[..., 1:], n1], axis=-1)
        nxt2 = np.concatenate([b2[..., 1:], n2], axis=-1)
        c = ci[:, None, None, None]
        b1, b2 = b1 - c * b2, nxt2 - c * nxt1
        num, den = partials(N - i - 1)
    return -a[:, :order], np.where(bad, 1, 0).astype(np.int32)


def _check(x: np.ndarray, order: int, config=None, coeffs: bool = True) -> None:
    config = config or B.launch_config(x.shape[1], DTYPES[x.dtype.type])
    cm, sm = _model_burg(x, order, config.threads, config.width, config.blocks)
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
    cluster layout's largest, 8 blocks of 448 threads in float32, 224 in
    float64): 512 threads of 442 pairs in float32, 221 in float64, the last
    warp partly live."""
    t = DTYPES[dt]
    switch = 225794 if dt == np.float32 else 112898
    assert B.launch_config(switch - 1, t) == ("cluster", 448 if dt == np.float32 else 224, 63, 8)
    assert B.launch_config(switch, t) == ("device", 512, 442 if dt == np.float32 else 221, 1)
    for n in (switch - 1, switch):
        _check(_frames(n, 1, dt, noise=0.1), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_model_past_the_cluster_switch(dt):
    """The first n whose rows go over a cluster, and the n before it (the
    shared layout's largest): 2 blocks of 256 threads in float32, 128 in
    float64, the second block's last warp partly live."""
    t = DTYPES[dt]
    switch = 28968 if dt == np.float32 else 14498
    assert B.launch_config(switch - 1, t).rows == "shared"
    assert B.launch_config(switch, t) == ("cluster", 256 if dt == np.float32 else 128, 63, 2)
    for n in (switch - 1, switch):
        _check(_frames(n, 2, dt, noise=0.1), 13)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("blocks", [2, 4])
def test_model_at_cluster_sizes(blocks, dt):
    """The cluster layout's first frame at 4 and 8 blocks and the frame
    before it (the largest at 2 and 4): every block's share full but the
    last's, one pair under the cluster's reach."""
    t = DTYPES[dt]
    most = 448 if dt == np.float32 else 224  # the most threads whose share fits a block
    last = blocks * most * 63 + 1
    assert B.launch_config(last, t) == ("cluster", most, 63, blocks)
    assert B.launch_config(last + 1, t).blocks == 2 * blocks
    for n in (last, last + 1):
        _check(_frames(n, 1, dt, noise=0.1), 13)


def _cluster(n: int, blocks: int) -> B.BurgConfig:
    """The cluster layout's launch at any block count: the fewest whole warps
    whose threads hold a share of the pairs at the shared layout's width."""
    share = -(-(n - 1) // blocks)
    return B.BurgConfig("cluster", B._threads(share + 1, B._SHARED_WIDTH), B._SHARED_WIDTH, blocks)


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_model_cluster_on_recording(blocks, dt):
    """C blocks of a cluster on the recording's CLI frames, order 13, and at
    a width of 5 pairs, where every block's share is live."""
    x = _frames(2205, 3, dt)
    _check(x, 13, _cluster(2205, blocks))
    _check(x, 13, B.BurgConfig("cluster", 32 * -(-2204 // (blocks * 32 * 5)), 5, blocks))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("blocks", [2, 3, 4])
@pytest.mark.parametrize("n,order", [(2, 1), (3, 1), (3, 2)])
def test_model_cluster_short_frames(n, order, blocks, dt):
    """test_model_short_frames' frames over a cluster: the blocks past the
    first hold no pair."""
    x = np.random.default_rng(n).standard_normal((5, n)).astype(dt)
    _check(x, order, _cluster(n, blocks))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_model_cluster_at_width_edges(blocks, dt):
    """n - 1 equal to C x threads x c, one under and one over (the last takes
    another warp in every block), for the CLI default's cluster launch."""
    config = _cluster(2205, blocks)
    full = blocks * config.threads * config.width
    for n in (full, full + 1, full + 2):
        got = _cluster(n, blocks)
        assert got.blocks * got.threads * got.width >= n - 1
        assert got.threads == config.threads + 32 * (n == full + 2)
        _check(_frames(n, 2, dt), 13, got)


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
    range it had: up to 28,967 float32 and 14,497 float64 samples), then a
    cluster of the fewest of 2, 4 and 8 blocks whose shares fit a block, up
    to 8 blocks of 448 threads in float32 and 224 in float64 (225,793 and
    112,897 samples), then 512 threads with the rows in device memory."""
    for dt, width, largest, top in ((torch.float32, 35, 28967, 225793), (torch.float64, 23, 14497, 112897)):
        switch = 512 * width + 2  # the first n whose pairs exceed the registers
        seen = {}
        for n in range(2, (1 << 20) + 1):
            c = B.launch_config(n, dt)
            seen.setdefault(c.rows, [n, n])[1] = n
            assert c.blocks * c.threads * c.width >= n - 1
        assert seen == {"registers": [2, switch - 1], "shared": [switch, largest], "cluster": [largest + 1, top],
                        "device": [top + 1, 1 << 20]}
        for n in [*range(2, 300), 2047, 2048, 2205, 4096, switch - 2, switch - 1, switch, switch + 1, largest,
                  largest + 1, 28927, 14431, 29100, 14600, 32768, 65536, top - 1, top, top + 1, (1 << 20) - 1,
                  1 << 20]:
            c = B.launch_config(n, dt)
            assert c == B.launch_config(n, dt) and c == B.layout(n, dt, c.rows)
            assert c.threads <= B._MAX_THREADS and B.smem_bytes(n, dt, c) <= B._SMEM_LIMIT
            if c.rows == "device":
                assert c.threads == 512 and c.threads * c.width >= n - 1 > c.threads * (c.width - 1)
                assert B.smem_bytes(n, dt, c) == 4 * 16 * 8 + 4 * 16 * dt.itemsize  # the slots alone
            elif c.rows == "cluster":
                # the fewest blocks whose shares fit, each share in the fewest warps
                share = -(-(n - 1) // c.blocks)
                assert c.width == 63 and c.blocks in (2, 4, 8)
                assert c.threads % 32 == 0 and c.threads * c.width >= share > (c.threads - 32) * c.width
                for fewer in (f for f in (2, 4) if f < c.blocks):
                    t = 32 * -(-(-(-(n - 1) // fewer)) // (32 * 63))
                    assert t > B._MAX_THREADS or B.smem_bytes(n, dt, B.BurgConfig("cluster", t, 63, fewer)) > \
                        B._SMEM_LIMIT
            else:
                assert c.blocks == 1
                assert c.threads % 32 == 0 and c.threads * c.width >= n - 1 > c.threads * c.width - 32 * c.width
                assert c.width == (63 if c.rows == "shared" else width)
    # The kernel B replaced took 2 n values and its static shared memory
    # (1,032 bytes in float, 1,548 in double) within the 232,448 a block may
    # take: the longest frames it took are the shared layout's longest, and
    # the next lengths take the cluster layout.
    assert B.launch_config(29100, torch.float32) == ("cluster", 256, 63, 2)
    assert B.launch_config(14600, torch.float64) == ("cluster", 128, 63, 2)
    assert B.layout(29100, torch.float32, "shared") is None and B.layout(14600, torch.float64, "shared") is None
    # The path's long frames: 32,768 over 2 blocks in float32 and 4 in
    # float64, 16,384 float64 over 2.
    assert B.launch_config(32768, torch.float32) == ("cluster", 288, 63, 2)
    assert B.launch_config(32768, torch.float64) == ("cluster", 160, 63, 4)
    assert B.launch_config(16384, torch.float64) == ("cluster", 160, 63, 2)
    assert B.layout(225794, torch.float32, "cluster") is None and B.layout(112898, torch.float64, "cluster") is None
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
    assert max(B._CLUSTERS) == const("kMaxCluster") == 8
    assert "return round16(rows * sizeof(T)) + 4 * W * sizeof(double) + 4 * W * sizeof(T);" in src
    assert ("if (where == kRowsCluster) return round16(rows * sizeof(T)) + 16 + 4 * blocks * W * (sizeof(double) + "
            "sizeof(T));") in src
    assert ("where == kRowsShared ? 2 * static_cast<size_t>(N - 1)\n"
            "                      : where == kRowsCluster ? 2 * static_cast<size_t>(threads) * kSharedWidth\n"
            "                      : where == kRowsRegisters ? static_cast<size_t>(N) : 0;") in src
    assert B.ROWS == {name: const(f"kRows{name.capitalize()}") for name in ("registers", "shared", "device", "cluster")}


def test_stack_checked_counts_every_instantiation():
    """chip_smoke.py's phase 2 holds every instantiation of kernel B to 0
    bytes of stack and spill: burg_kernel at the three single-block layouts
    and burg_cluster_kernel, in each dtype."""
    from chip_smoke import STACK_CHECKED

    src = CU.read_text()
    assert src.count("return launch_with<T, ") == 3 and "const auto kernel = burg_cluster_kernel<T>;" in src
    assert STACK_CHECKED["burg_kernel"] == 3 * 2 and STACK_CHECKED["burg_cluster_kernel"] == 2


def test_chip_smoke_long_frames_take_their_layout():
    """chip_smoke.py's BURG_LARGE cases name the layout the rule gives them,
    and cover each layout in each dtype, the register layout at its largest
    frame included, the cluster layout at 32,768 and 65,536 float32 and
    16,384 and 32,768 float64 samples, at each cluster size the rule uses
    and at its largest frame, and the device layout at the next, with 8 to
    16 frames at the cluster's largest and past it."""
    from chip_smoke import BURG_LARGE

    for dname, n, _, rows in BURG_LARGE:
        assert B.launch_config(n, getattr(torch, dname)).rows == rows
    for dname, width, top in (("float32", 35, 225793), ("float64", 23, 112897)):
        dt = getattr(torch, dname)
        cases = {(n, rows) for d, n, _, rows in BURG_LARGE if d == dname}
        assert (512 * width + 1, "registers") in cases and any(rows == "shared" for _, rows in cases)
        path = {32768, 65536} if dname == "float32" else {16384, 32768}
        assert path <= {n for n, r in cases if r == "cluster"}
        assert {B.launch_config(n, dt).blocks for n, rows in cases if rows == "cluster"} == {2, 4, 8}
        assert (top, "cluster") in cases and {n for n, rows in cases if rows == "device"} == {top + 1}
        assert all(8 <= f <= 16 for d, n, f, _ in BURG_LARGE if d == dname and n in (top, top + 1))


@pytest.mark.parametrize("order", [40, 127])
def test_plain_matches_jax_at_high_orders(order):
    """Orders the card took only up to 64 before: the plain version against
    voxtpu's jnp Burg on the recording's frames, float64. voxtpu's Burg runs
    under jax.jit (one program; eagerly every order slices at a new length
    and compiles its own)."""
    x = _frames(2205, 4, np.float64)
    got, gstatus = B.burg_plain(torch.as_tensor(x), order)
    want, wstatus = jax.jit(jax_burg, static_argnums=1, static_argnames="backend")(jnp.asarray(x), order,
                                                                                    backend="jnp")
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
