"""Hamming-distance kernels over bit-packed hash matrices.

Instead of translating the reference's per-pair XOR+POPCNT scalar loop
(``video_hash.rs:311-317``), distances ride the matrix units.  A hash's
1024 storage bits become a length-1024 +/-1 vector, and for hashes a, b:

    dot(a_pm, b_pm) = 1024 - 2 * hamming        (over all storage bits,
                                                 like the reference's
                                                 16-word popcount)

so a tile of pairwise distances is one int8 matmul with exact int32
accumulation.
Duration windowing (the reference's two-pointer sweep) becomes a banded
block iteration: hashes are sorted by duration, so each row's candidate
window is a contiguous column range, and whole blocks outside the band are
never touched.

The ``host`` backend mirrors the same math in NumPy (f32 BLAS dot; exact,
since all values are small integers).
"""

from __future__ import annotations

import os

import numpy as np

from .. import platform
from ..definitions import HASH_BITS_PADDED

_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def unpack_pm1_host(packed: np.ndarray, dtype=np.float32) -> np.ndarray:
    """uint32[N, 32] -> {-1, +1}[N, 1024].

    All 1024 storage bits participate, exactly like the reference's
    per-word popcount over [usize; 16] (video_hash.rs:311-317) — real
    hashes always have zero pad bits, but synthetic test hashes may not.
    dot(a, b) = 1024 - 2 * hamming."""
    n = packed.shape[0]
    bits = (packed[:, :, None] >> _BIT_SHIFTS[None, None, :]) & np.uint32(1)
    pm = (bits.astype(np.int8) * 2 - 1).reshape(n, HASH_BITS_PADDED)
    return pm.astype(dtype)


def hamming_matrix_host(packed_a: np.ndarray, packed_b: np.ndarray) -> np.ndarray:
    """Dense pairwise Hamming distances via XOR+popcount (small inputs)."""
    x = packed_a[:, None, :] ^ packed_b[None, :, :]
    return np.bitwise_count(x).sum(axis=2).astype(np.int64)


def _pairs_from_block(
    adj: np.ndarray, r0: int, c0: int
) -> tuple[np.ndarray, np.ndarray]:
    ii, jj = np.nonzero(adj)
    return ii.astype(np.int64) + r0, jj.astype(np.int64) + c0


def banded_adjacency_host(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    row_block: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j), i < j < bounds[i], with hamming <= tolerance_int.

    NumPy implementation of the banded block sweep: exact-integer f32 dot.
    """
    n = packed.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pm = unpack_pm1_host(packed)
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        c0 = r0 + 1
        c1 = int(bounds[r0:r1].max())
        if c1 <= c0:
            continue
        dot = pm[r0:r1] @ pm[c0:c1].T  # exact: integers < 2^24 in f32
        dist = (HASH_BITS_PADDED - dot) * 0.5
        rows = np.arange(r0, r1)[:, None]
        cols = np.arange(c0, c1)[None, :]
        adj = (
            (dist <= tolerance_int)
            & (cols > rows)
            & (cols < bounds[r0:r1, None])
        )
        if adj.any():
            ii, jj = _pairs_from_block(adj, r0, c0)
            out_i.append(ii)
            out_j.append(jj)
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(out_i), np.concatenate(out_j)


# -- device (JAX) path --------------------------------------------------------


def _get_device_fns():
    """Build (lazily) the jitted device kernels.  Import of jax is deferred
    so host-only callers never touch it."""
    global _DEVICE_FNS
    try:
        return _DEVICE_FNS
    except NameError:
        pass
    import jax
    import jax.numpy as jnp

    def unpack_pm1(packed):
        """uint32[K, 32] -> int8[K, 1024] over {-1, +1} (all storage bits)."""
        k = packed.shape[0]
        shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
        bits = (packed[:, :, None] >> shifts) & jnp.uint32(1)
        return (bits.astype(jnp.int8).reshape(k, HASH_BITS_PADDED) * 2 - 1)

    def block_kernel(rows_packed, cols_packed, row_ids, col_ids, row_bounds, tol):
        """Distances for one (TM, TC) tile -> bitpacked adjacency + count."""
        # bf16 operands with f32 accumulation: exact for +/-1 over 1024
        # terms
        a = unpack_pm1(rows_packed).astype(jnp.bfloat16)
        b = unpack_pm1(cols_packed).astype(jnp.bfloat16)
        dot = jax.lax.dot_general(
            a,
            b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dist = ((HASH_BITS_PADDED - dot) * 0.5).astype(jnp.int32)
        adj = (
            (dist <= tol)
            & (col_ids[None, :] > row_ids[:, None])
            & (col_ids[None, :] < row_bounds[:, None])
        )
        count = jnp.sum(adj, dtype=jnp.int32)
        tm, tc = adj.shape
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
        packed_adj = jnp.sum(
            adj.reshape(tm, tc // 32, 32).astype(jnp.uint32) * weights,
            axis=-1,
            dtype=jnp.uint32,
        )
        return packed_adj, count

    _DEVICE_FNS = {
        "block_kernel": jax.jit(block_kernel),
        "unpack_pm1": jax.jit(unpack_pm1),
        # jitted ONCE: a per-call jax.jit(lambda ...) retraces and
        # re-deserializes the persistent-cache entry every invocation
        "unpack_pm1_bf16": jax.jit(
            lambda p: unpack_pm1(p).astype(jnp.bfloat16)
        ),
    }
    return _DEVICE_FNS


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def banded_adjacency_device(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    row_block: int = 8192,
) -> tuple[np.ndarray, np.ndarray]:
    """Device banded adjacency sweep: the XLA tile loop (the ``device``
    backend, and the plain reference of the two-phase sweep).

    One jit-compiled tile kernel is reused across all blocks (shapes are
    bucketed to fixed sizes to avoid recompiles).  Only the per-tile match
    *count* is fetched eagerly; the bitpacked adjacency tile is transferred
    to host only when non-empty — on real libraries almost all tiles are.
    """
    import jax.numpy as jnp

    n = packed.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    fns = _get_device_fns()
    kernel = fns["block_kernel"]
    bounds = np.asarray(bounds, dtype=np.int64)

    # Fixed column-tile width: max band width over row blocks, bucketed, so a
    # single compiled kernel covers every tile.
    max_band = 128
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        band = int(bounds[r0:r1].max()) - (r0 + 1)
        max_band = max(max_band, band)
    tc = _round_up(min(max_band, row_block), 128)

    # Pad the device-resident matrix so any [c0, c0+tc) slice is in bounds.
    n_pad = _round_up(n, 128) + tc
    packed_pad = np.zeros((n_pad, packed.shape[1]), dtype=np.uint32)
    packed_pad[:n] = packed
    dev_packed = jnp.asarray(packed_pad)

    tm = _round_up(min(row_block, n), 128)
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for r0 in range(0, n, row_block):
        r1 = min(r0 + row_block, n)
        rows = dev_packed[r0 : r0 + tm]
        row_ids = np.full(tm, -1, dtype=np.int32)
        row_ids[: r1 - r0] = np.arange(r0, r1)
        rb = np.full(tm, -1, dtype=np.int32)
        rb[: r1 - r0] = np.minimum(bounds[r0:r1], n)
        row_ids_d = jnp.asarray(row_ids)
        rb_d = jnp.asarray(rb)

        c_end = int(bounds[r0:r1].max())
        c0 = r0 + 1
        while c0 < c_end:
            cols = dev_packed[c0 : c0 + tc]
            col_ids = np.arange(c0, c0 + tc, dtype=np.int64)
            col_ids_np = np.where(col_ids < n, col_ids, -(10**9)).astype(
                np.int32
            )
            packed_adj, count = kernel(
                rows, cols, row_ids_d, jnp.asarray(col_ids_np), rb_d,
                np.int32(tolerance_int),
            )
            if int(count) > 0:
                adj_bits = np.asarray(packed_adj)
                # unpack uint32 tile back to booleans (cheap: tiles sparse)
                bits = (
                    (adj_bits[:, :, None] >> _BIT_SHIFTS[None, None, :]) & 1
                ).reshape(tm, tc).astype(bool)
                ii, jj = np.nonzero(bits)
                out_i.append(row_ids[ii].astype(np.int64))
                out_j.append(col_ids_np[jj].astype(np.int64))
            c0 += tc
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]


def _get_window_kernel():
    """Jitted tile kernel for the references search: per-row [lo, hi)
    column windows instead of the self-search's j > i band."""
    global _WINDOW_KERNEL
    try:
        return _WINDOW_KERNEL
    except NameError:
        pass
    import jax
    import jax.numpy as jnp

    unpack_pm1 = _get_device_fns()["unpack_pm1"]

    def window_kernel(rows_packed, cols_pm, row_lo, row_hi, col_ids, tol):
        # bf16 operands (cols pre-unpacked ONCE by the caller): bf16 ->
        # f32 accumulation is exact for +/-1 operands
        a = unpack_pm1(rows_packed).astype(jnp.bfloat16)
        b = cols_pm
        dot = jax.lax.dot_general(
            a,
            b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dist = ((HASH_BITS_PADDED - dot) * 0.5).astype(jnp.int32)
        adj = (
            (dist <= tol)
            & (col_ids[None, :] >= row_lo[:, None])
            & (col_ids[None, :] < row_hi[:, None])
        )
        count = jnp.sum(adj, dtype=jnp.int32)
        tm, tc = adj.shape
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[
            None, None, :
        ]
        packed_adj = jnp.sum(
            adj.reshape(tm, tc // 32, 32).astype(jnp.uint32) * weights,
            axis=-1,
            dtype=jnp.uint32,
        )
        return packed_adj, count

    _WINDOW_KERNEL = jax.jit(window_kernel)
    return _WINDOW_KERNEL


def windowed_adjacency_device(
    rows_packed: np.ndarray,
    cols_packed: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    row_block: int = 512,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j) with lo[i] <= j < hi[i] and hamming <= tolerance,
    in lexicographic order — the device path for
    ``search_with_references`` (rows = duration-sorted references,
    columns = candidate entries, the reference's [0.95d, 1.05d] window
    giving each row a contiguous column range).

    ``row_block`` trades launch count against padded work: each block
    sweeps the UNION of its rows' windows, so smaller blocks keep the
    swept rectangle close to the useful band."""
    import jax
    import jax.numpy as jnp

    r = rows_packed.shape[0]
    n = cols_packed.shape[0]
    if r == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    kernel = _get_window_kernel()
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)

    # column-chunk size buckets: a handful of big calls (XLA tiles
    # internally), with count fetches deferred until all dispatch
    buckets = (65536, 16384, 4096)
    n_pad = _round_up(n, 32) + buckets[0]
    cols_pad = np.zeros((n_pad, cols_packed.shape[1]), np.uint32)
    cols_pad[:n] = cols_packed
    # unpack the candidate matrix ONCE (bf16 [n_pad, 1024]); slices feed
    # every call instead of re-unpacking per chunk
    dev_cols = _get_device_fns()["unpack_pm1_bf16"](jnp.asarray(cols_pad))

    tm = _round_up(min(row_block, r), 32)
    pending: list[tuple[object, object, int, int]] = []
    for r0 in range(0, r, row_block):
        r1 = min(r0 + row_block, r)
        rows = np.zeros((tm, rows_packed.shape[1]), np.uint32)
        rows[: r1 - r0] = rows_packed[r0:r1]
        row_lo = np.full(tm, 2**30, np.int32)  # pad rows match nothing
        row_lo[: r1 - r0] = lo[r0:r1]
        row_hi = np.zeros(tm, np.int32)
        row_hi[: r1 - r0] = np.minimum(hi[r0:r1], n)
        rows_d = jnp.asarray(rows)
        row_lo_d = jnp.asarray(row_lo)
        row_hi_d = jnp.asarray(row_hi)

        c0 = int(lo[r0:r1].min()) if r1 > r0 else 0
        c_end = int(np.minimum(hi[r0:r1], n).max())
        while c0 < c_end:
            tc = next(
                (b for b in buckets if b <= c_end - c0), buckets[-1]
            )
            col_ids = np.arange(c0, c0 + tc, dtype=np.int32)
            packed_adj, count = kernel(
                rows_d,
                dev_cols[c0 : c0 + tc],
                row_lo_d,
                row_hi_d,
                jnp.asarray(col_ids),
                np.int32(tolerance_int),
            )
            # defer the count fetch: all calls dispatch back-to-back
            pending.append((packed_adj, count, r0, c0))
            c0 += tc

    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    for packed_adj, count, r0, c0 in pending:
        if int(count) == 0:
            continue
        adj_bits = np.asarray(packed_adj)
        tm_, tw = adj_bits.shape
        bits = (
            (adj_bits[:, :, None] >> _BIT_SHIFTS[None, None, :]) & 1
        ).reshape(tm_, tw * 32).astype(bool)
        ii, jj = np.nonzero(bits)
        out_i.append(ii.astype(np.int64) + r0)
        out_j.append(jj.astype(np.int64) + c0)
    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]


def banded_adjacency(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    backend: str = "auto",
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch: 'pallas*' (the two-phase device sweep states), 'device'
    (the XLA tile loop), 'ring' (the multi-device sweep), 'native' (C++),
    'host' (NumPy).

    'auto' takes the two-phase device sweep on a GPU and the native host
    sweep on the CPU backend.  Device errors propagate: there is no
    silent host rerun.
    """
    if backend == "host":
        return banded_adjacency_host(packed, bounds, tolerance_int)
    if backend == "native":
        from ..native import banded_adjacency_native

        packed64 = np.ascontiguousarray(packed).view(np.uint64)
        return banded_adjacency_native(packed64, bounds, tolerance_int)
    if backend == "pallas":
        from .hamming_pallas import banded_adjacency_pallas

        return banded_adjacency_pallas(packed, bounds, tolerance_int)
    if backend == "pallas_streamed":
        from .hamming_pallas import PallasSearchState, banded_adjacency_pallas

        st = PallasSearchState(packed, bounds, defer_upload=True)
        return banded_adjacency_pallas(
            packed, bounds, tolerance_int, state=st
        )
    if backend == "pallas_windowed":
        # sliding +/-1 window over a packed-resident library: the path for
        # libraries whose int8 +/-1 expansion exceeds the device budget
        from .hamming_pallas import (
            WindowedPallasState,
            banded_adjacency_pallas,
        )

        st = WindowedPallasState(packed, bounds)
        return banded_adjacency_pallas(
            packed, bounds, tolerance_int, state=st
        )
    if backend == "pallas_split":
        # independent rows/cols +/-1 windows: capacity bounded by the
        # 128 B/hash packed matrix alone (the single window's minimum
        # size is the widest band span)
        from .hamming_pallas import (
            SplitWindowState,
            banded_adjacency_pallas,
        )

        st = SplitWindowState(packed, bounds)
        return banded_adjacency_pallas(
            packed, bounds, tolerance_int, state=st
        )
    if backend == "ring":
        from ..parallel.sharded_search import banded_adjacency_ring

        return banded_adjacency_ring(packed, bounds, tolerance_int)
    if backend == "device":
        return banded_adjacency_device(packed, bounds, tolerance_int)
    if backend != "auto":
        raise ValueError(f"unknown search backend {backend!r}")
    if platform.device_sweep():
        return _banded_adjacency_device_auto(packed, bounds, tolerance_int)
    # CPU backend: the C++ XOR+POPCNT sweep; NumPy only when the native
    # module cannot be built
    from ..native import available as _native_ok
    from ..native import banded_adjacency_native

    if _native_ok():
        packed64 = np.ascontiguousarray(packed).view(np.uint64)
        return banded_adjacency_native(packed64, bounds, tolerance_int)
    return banded_adjacency_host(packed, bounds, tolerance_int)


def _banded_adjacency_device_auto(
    packed: np.ndarray, bounds: np.ndarray, tolerance_int: int
) -> tuple[np.ndarray, np.ndarray]:
    """``auto`` on the device: the ring over several devices, else the
    resident, windowed or split two-phase sweep state by size."""
    import jax

    from ..parallel.ring_pallas import ring_capacity_ok

    n = packed.shape[0]
    if (
        len(jax.devices()) > 1
        and os.environ.get("VDF_AUTO_RING", "1") == "1"
        and n >= int(os.environ.get("VDF_RING_MIN_N", "1000000"))
        # a shard whose band-spanning column window would overflow the
        # device has no ring path: fall through to the single-device
        # windowed/split states, whose capacity is packed-matrix-bound
        and ring_capacity_ok(n, bounds, len(jax.devices()))
    ):
        # several devices: shard the library over the mesh (per-device
        # work O(band / n_devices)).  Below VDF_RING_MIN_N the ring's
        # fixed costs (per-step operand unpack, setup and drains) are
        # expected to lose to the single-device sweep; the crossover
        # was not measured on this card.
        from ..parallel.ring_pallas import banded_adjacency_ring

        return banded_adjacency_ring(packed, bounds, tolerance_int)
    from .hamming_pallas import (
        SplitWindowState,
        WindowedPallasState,
        banded_adjacency_pallas,
        should_split,
    )

    if n >= platform.resident_rows():
        # past the resident +/-1 budget, slide a window; past the point
        # where packed + the minimum single window no longer fit, split
        # the rows/cols windows
        cls = (
            SplitWindowState
            if should_split(n, bounds)
            else WindowedPallasState
        )
        st = cls(packed, bounds)
        return banded_adjacency_pallas(
            packed, bounds, tolerance_int, state=st
        )
    return banded_adjacency_pallas(packed, bounds, tolerance_int)
