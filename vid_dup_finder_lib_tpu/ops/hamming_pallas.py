"""Two-phase banded Hamming sweep on the device.

The sweep covers each row's duration band ``[row_lo + 1, bounds)`` with
launches of R_TILES row tiles x BAND_TILES column tiles (a tile is
TILE_M x TILE_N pairs), each launch positioned by its own scalar vector:

    int8 +/-1 operands (exact int32 accumulation) -> dot -> tolerance and
    duration-window masks -> one match count per tile (phase A) or a
    transposed 1-bit-per-pair pack (phase B)

Phase A runs the counts-only launch over the whole band.  Phase B re-runs
the packing launch over the hit tiles only, and one fused XLA program
extracts their pairs.  A count per tile and a bit per pair are the point of
the design: an unfused product writes and re-reads an int32 distance (8 B)
per pair, while the dot itself costs 2,048 integer operations per pair.

Every launch has one contract,
``(scalars, rows_pm, cols_pm, bounds, row_lo) -> (words, counts)`` or
``-> counts``, and two implementations:

* ``plain``: jax.numpy/lax — a dynamic_slice by the scalars, an int8
  dot_general with an int32 result, the masks, the count or the pack.  It
  is the reference, the CPU route and the competitor.
* ``triton``: a Pallas kernel through Triton — a grid of independent
  blocks, each loading its own launch scalars, running a K-loop over the
  1024 int8 columns and applying masks, counts and the bitpack in
  registers.

The bitpack is transposed: output word [r, c] packs rows r*32..r*32+31 of
column c.
"""

from __future__ import annotations

import functools
import os
import sys
import time
import typing

import numpy as np

from .. import platform
from ..definitions import HASH_BITS_PADDED

# +/-1 operand dtype: int8 (exact int32 accumulation) or bf16 (exact f32
# accumulation).
PM_DTYPE = os.environ.get("VDF_PM_DTYPE", "int8")

# Launch geometry: TILE_M x TILE_N is one count tile, and a launch covers
# R_TILES x BAND_TILES of them.  These are the planner's launch unit; they
# were not measured on this card (tuning them is a performance task).
TILE_M = int(os.environ.get("VDF_TILE_M", "1024"))
TILE_N = int(os.environ.get("VDF_TILE_N", "1024"))
R_TILES = int(os.environ.get("VDF_R_TILES", "1"))
BAND_TILES = int(os.environ.get("VDF_BAND_TILES", "16"))

# pad-row lower-bound sentinel: no real column id ever exceeds it
_ROW_LO_SENTINEL = 2**30

# Triton block: rows, columns, K-step, warps, pipeline stages.  Rows are a
# multiple of 64 (one warpgroup MMA) and of 32 (one packed word).  The
# best of six blocks in a first probe on an H100 (PERF.md), not tuned.
TRITON_BLOCK = (128, 128, 128, 8, 3)


def sweep_launch() -> str:
    """The launch the sweep drivers use: the Triton kernels on a GPU
    (2.2x the plain launch end to end on the 1M sweep, PERF.md), the
    plain launch on the CPU backend."""
    return "plain" if platform.backend() == "cpu" else "triton"


class Geometry(typing.NamedTuple):
    """Launch tile geometry as an explicit, hashable parameter.

    Threaded through every cached launch builder and stored on search
    states (``state.geom``), so two geometries can coexist in one process
    (the production tiles next to a tiny test geometry, or the
    BAND_TILES=1 phase-B repack next to the BAND_TILES=16 counts sweep).
    The defaults bind the VDF_TILE_M/VDF_TILE_N/VDF_R_TILES/
    VDF_BAND_TILES env knobs read at import, so ``Geometry()`` is the
    configured production geometry.
    """

    tile_m: int = TILE_M
    tile_n: int = TILE_N
    r_tiles: int = R_TILES
    band_tiles: int = BAND_TILES

    @property
    def n_scal(self) -> int:
        # launch-scalar vector length (layout: see N_SCAL comment above)
        return 5 + 3 * self.r_tiles

# phase breakdown of the most recent banded_adjacency_pallas sweep
# (seconds + counters) — bench.py reports it alongside the headline rate
LAST_SWEEP_PHASES: dict = {}

# launch-scalar vector length: [0] tol, [1] n (col clamp), [2] first row
# tile (operand-relative), [3 + i] first col tile per row tile,
# [3 + R + i] min_bound, [3 + 2R + i] max_row_lo, [3 + 3R] col window
# base (TILE_N units), [4 + 3R] ROW window base in TILE_M units — or -1
# to read per-row lower bounds from the row_lo operand (the refs
# search); >= 0 means row_lo is the global row index, computed in the
# launch from an iota, so self-search states need no row_lo operand.
# [3 + R + i] and [3 + 2R + i] are per-tile window extrema kept for the
# planners; the launches mask every element.
N_SCAL = 5 + 3 * R_TILES


def _pack_words(adj):
    """bool[M, W] -> int32[M // 32, W]: word [r, c] packs rows
    r*32..r*32+31 of column c (bit b = row r*32 + b).  The bits are
    distinct, so the int32 sum is their OR (bit 31 wraps to the sign)."""
    import jax
    import jax.numpy as jnp

    m, w = adj.shape
    shifts = jax.lax.broadcasted_iota(jnp.int32, (1, 32, 1), 1)
    bits = adj.astype(jnp.int32).reshape(m // 32, 32, w)
    return jnp.sum(bits << shifts, axis=1, dtype=jnp.int32)


def _acc_dtype():
    import jax.numpy as jnp

    return jnp.int32 if PM_DTYPE == "int8" else jnp.float32


def _plain_adj(geom, scalars, rows_pm, cols_pm, bounds, row_lo, i):
    """Row tile ``i`` of one launch -> bool[TILE_M, BAND_TILES * TILE_N]
    adjacency, tolerance and duration-window masks applied.

    Each row's valid columns are [row_lo + 1, bounds): the self-search
    passes row_lo = the row's own global index (j > i), the references
    search its [0.95d, 1.05d] window's lower edge - 1."""
    import jax
    import jax.numpy as jnp

    tm, tn, r_tiles, band = geom
    width = band * tn
    acc = _acc_dtype()
    r0 = (scalars[2] + i) * tm
    ct = scalars[3 + i]
    a = jax.lax.dynamic_slice_in_dim(rows_pm, r0, tm, 0)
    b = jax.lax.dynamic_slice_in_dim(cols_pm, ct * tn, width, 0)
    dot = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())), preferred_element_type=acc
    )
    # dist <= tol  <=>  dot >= 1024 - 2*tol (all 1024 storage bits
    # count, like the reference's 16-word popcount)
    thresh = (HASH_BITS_PADDED - 2 * scalars[0]).astype(acc)
    col_ids = (ct + scalars[3 + 3 * r_tiles]) * tn + (
        jax.lax.broadcasted_iota(jnp.int32, (1, width), 1)
    )
    row_base = scalars[4 + 3 * r_tiles]
    own = (row_base + scalars[2] + i) * tm + (
        jax.lax.broadcasted_iota(jnp.int32, (tm, 1), 0)
    )
    rlo = jnp.where(
        row_base >= 0, own, jax.lax.dynamic_slice_in_dim(row_lo, r0, tm, 0)
    )
    lim = jnp.minimum(
        jax.lax.dynamic_slice_in_dim(bounds, r0, tm, 0), scalars[1]
    )
    return (dot >= thresh) & (col_ids > rlo) & (col_ids < lim)


def _plain_launch(geom, mode: str):
    """Plain launch: ``mode`` "pack" -> int32[R, BAND, TILE_M//32, TILE_N]
    words, "tile_counts" -> int32[R, BAND] counts."""
    import jax.numpy as jnp

    tm, tn, r_tiles, band = geom

    def launch(scalars, rows_pm, cols_pm, bounds, row_lo):
        outs = []
        for i in range(r_tiles):
            adj = _plain_adj(
                geom, scalars, rows_pm, cols_pm, bounds, row_lo, i
            )
            if mode == "pack":
                words = _pack_words(adj)
                outs.append(
                    words.reshape(tm // 32, band, tn).transpose(1, 0, 2)
                )
            else:
                outs.append(
                    jnp.sum(
                        adj.reshape(tm, band, tn), axis=(0, 2),
                        dtype=jnp.int32,
                    )
                )
        return jnp.stack(outs)

    return launch


def _triton_block(geom) -> tuple[int, int, int, int, int]:
    bm, bn, bk, warps, stages = TRITON_BLOCK
    bm, bn = min(bm, geom.tile_m), min(bn, geom.tile_n)
    bk = min(bk, HASH_BITS_PADDED)
    assert geom.tile_m % bm == 0 and geom.tile_n % bn == 0
    assert bm % 32 == 0 and HASH_BITS_PADDED % bk == 0
    return bm, bn, bk, warps, stages


@functools.cache
def _wide_triton_offsets() -> None:
    """Make JAX's Triton lowering use 64-bit element offsets for every
    array of 2**31 bytes or more.

    The installed lowering (``_compute_offsets_from_indices``) switches
    to 64 bits only above 2**32 bytes, so a load from a 2-4 GiB int8 +/-1
    operand (2M-4M rows) overflows the signed 32-bit offset and faults
    (CUDA_ERROR_ILLEGAL_ADDRESS).  The wrapper shows the helper such an
    array as 4x longer along its leading axis, which crosses the
    threshold and leaves every stride unchanged."""
    import dataclasses

    from jax._src.pallas.triton import lowering

    original = lowering._compute_offsets_from_indices

    def offsets(block_info, nd_indexer):
        aval = block_info.full_shape_dtype
        nbytes = aval.size * aval.dtype.itemsize
        if aval.shape and 2**31 <= nbytes <= 2**32:
            block_info = dataclasses.replace(
                block_info,
                full_shape_dtype=aval.update(
                    shape=(aval.shape[0] * 4, *aval.shape[1:])
                ),
            )
        return original(block_info, nd_indexer)

    lowering._compute_offsets_from_indices = offsets


def _triton_launch(geom, mode: str):
    """Triton launch, same contract and outputs as ``_plain_launch``.

    The launch region (R_TILES*TILE_M rows x BAND_TILES*TILE_N columns)
    is a grid of independent blocks.  Each block reads its launch scalars,
    accumulates its int8 dot over K in a loop, masks it, and writes either
    its packed words or one partial count; a second XLA pass sums the
    partial counts per tile (blocks run in no order, so nothing is
    accumulated across them)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    tm, tn, r_tiles, band = geom
    bm, bn, bk, warps, stages = _triton_block(geom)
    gm, gn = tm // bm, tn // bn
    grid = (r_tiles * gm, band * gn)
    acc_t = _acc_dtype()
    k_steps = HASH_BITS_PADDED // bk

    def kernel(scal_ref, rows_ref, cols_ref, bounds_ref, row_lo_ref,
               out_ref):
        pi = pl.program_id(0)
        pj = pl.program_id(1)
        i, mi = pi // gm, pi % gm  # row tile, row block within it
        j, ni = pj // gn, pj % gn  # col tile, col block within it
        rt = scal_ref[2] + i
        ct = scal_ref[3 + i]
        r0 = rt * tm + mi * bm
        c0 = (ct + j) * tn + ni * bn

        def k_step(kk, acc):
            k0 = pl.multiple_of(kk * bk, bk)
            a = rows_ref[pl.ds(r0, bm), pl.ds(k0, bk)]
            b = cols_ref[pl.ds(c0, bn), pl.ds(k0, bk)]
            return acc + jax.lax.dot_general(
                a, b, (((1,), (1,)), ((), ())), preferred_element_type=acc_t
            )

        dot = jax.lax.fori_loop(
            0, k_steps, k_step, jnp.zeros((bm, bn), acc_t)
        )
        thresh = (HASH_BITS_PADDED - 2 * scal_ref[0]).astype(acc_t)
        col_ids = (ct + j + scal_ref[3 + 3 * r_tiles]) * tn + ni * bn + (
            jax.lax.broadcasted_iota(jnp.int32, (1, bn), 1)
        )
        row_base = scal_ref[4 + 3 * r_tiles]
        own = (row_base + rt) * tm + mi * bm + (
            jax.lax.broadcasted_iota(jnp.int32, (bm, 1), 0)
        )
        rlo = jnp.where(row_base >= 0, own, row_lo_ref[pl.ds(r0, bm), :])
        lim = jnp.minimum(bounds_ref[pl.ds(r0, bm), :], scal_ref[1])
        adj = (dot >= thresh) & (col_ids > rlo) & (col_ids < lim)
        if mode == "pack":
            out_ref[
                i, j, pl.ds(mi * (bm // 32), bm // 32), pl.ds(ni * bn, bn)
            ] = _pack_words(adj)
        else:
            out_ref[pi, pj] = jnp.sum(adj.astype(jnp.int32))

    if mode == "pack":
        out_shape = (r_tiles, band, tm // 32, tn)
    else:
        out_shape = grid
    interpret = platform.interpret()
    platform.check_interpret(interpret)
    if not interpret:
        _wide_triton_offsets()
    call = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        grid=grid,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=warps, num_stages=stages
        ),
        interpret=interpret,
        name=f"vdf_sweep_{mode}",
    )

    def launch(scalars, rows_pm, cols_pm, bounds, row_lo):
        out = call(scalars, rows_pm, cols_pm, bounds, row_lo)
        if mode == "pack":
            return out
        return jnp.sum(out.reshape(r_tiles, gm, band, gn), axis=(1, 3))

    return launch


def _launch_fn(launch: str, geom, mode: str):
    if launch == "plain":
        return _plain_launch(geom, mode)
    if launch == "triton":
        return _triton_launch(geom, mode)
    raise ValueError(f"unknown sweep launch {launch!r}")


@functools.cache
def _build_chunk(launch: str = "plain", geom: Geometry = Geometry()):
    """Packing launch: (scalars, rows_pm, cols_pm, bounds, row_lo) ->
    (int32[R_TILES, BAND_TILES, TILE_M//32, TILE_N] words,
    int32[R_TILES, BAND_TILES] per-tile match counts).

    scalars: int32[N_SCAL] (layout: the N_SCAL comment).  Row and column
    tile indices are relative to the operands (a sliding window of the
    library, or the whole library); the masks use absolute ids via the
    window-base scalars.  ``rows_pm`` and ``cols_pm`` are usually the same
    array (self-search); the ring and the split/refs states pass distinct
    row and column windows.
    """
    from ..utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    pack = _launch_fn(launch, geom, "pack")

    def one_launch(scalars, rows_pm, cols_pm, bounds, row_lo):
        words = pack(scalars, rows_pm, cols_pm, bounds, row_lo)
        counts = jnp.sum(
            jax.lax.population_count(words), axis=(2, 3), dtype=jnp.int32
        )
        return words, counts

    return jax.jit(one_launch)


@functools.cache
def _build_chunk_counts(
    launch: str = "plain",
    geom: Geometry = Geometry(),
    per_tile: bool = False,
):
    """Counts-only launch: the same tiling and masks as ``_build_chunk``,
    but the only output is one int32 match count per row tile — or, with
    ``per_tile``, one per (row tile, column tile), so the phase-B repack
    re-runs only the hit TILES under a BAND_TILES=1 geometry.

    A few bytes of output per launch instead of the packed adjacency, so
    many launches stay in flight and count fetches amortize; the rare
    launches with matches are recomputed by the packing launch (phase B of
    ``banded_adjacency_pallas``)."""
    from ..utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    counts = _launch_fn(launch, geom, "tile_counts")

    def one_launch(scalars, rows_pm, cols_pm, bounds, row_lo):
        c = counts(scalars, rows_pm, cols_pm, bounds, row_lo)
        return c.reshape(-1) if per_tile else jnp.sum(c, axis=1)

    return jax.jit(one_launch)


# Launches per device sweep call: lax.scan drives up to SWEEP_CALLS
# launches inside ONE jit, so per-launch Python dispatch does not sit
# between launches.
SWEEP_CALLS = int(os.environ.get("VDF_SWEEP_CALLS", "1024"))

# Smaller precompiled batch sizes: padding a short launch list up to
# SWEEP_CALLS runs the padded launches' full work for nothing, so the
# driver picks the smallest batch size that fits the remainder.
SWEEP_SIZES = (SWEEP_CALLS, 256, 64, 16)


@functools.cache
def _build_sweep_counts(
    launch: str,
    sweep_calls: int,
    geom: Geometry = Geometry(),
    per_tile: bool = False,
):
    import jax

    chunk_fn = _build_chunk_counts(launch, geom, per_tile)

    @jax.jit
    def sweep(scalars_all, rows_pm, cols_pm, bounds, row_lo):
        """int32[sweep_calls, N_SCAL] -> int32[sweep_calls, R_TILES]
        per-row-tile match counts (the whole launch stripe summed), or
        [sweep_calls, R_TILES * BAND_TILES] per-tile counts."""

        def body(_, scal):
            return None, chunk_fn(scal, rows_pm, cols_pm, bounds, row_lo)

        _, counts_all = jax.lax.scan(body, None, scalars_all)
        return counts_all

    return sweep


# phase-B word extraction: capacity of the sized nonzero over one
# phase-B batch's packed adjacency words (each nonzero word holds >= 1
# matching pair; overflow falls back to per-launch host extraction)
EXTRACT_WORD_CAP = int(os.environ.get("VDF_EXTRACT_WORD_CAP", "16384"))
PHASE_B_CALLS = int(os.environ.get("VDF_PHASE_B_CALLS", "64"))
# Two-level extraction (VDF_PHASE_B_V2): jnp.nonzero lowers to a sort, so
# V2 first reduces words to 1024-word-row nonzero counts (one fused
# pass), sized-nonzeros the (tiny) row list, gathers only the hot rows,
# and runs the word-level sized nonzero over those — two small sorts
# instead of one over every word of the batch.
PHASE_B_V2 = os.environ.get("VDF_PHASE_B_V2", "1") == "1"
PHASE_B_HOT_ROWS = int(os.environ.get("VDF_PHASE_B_HOT_ROWS", "1024"))


@functools.cache
def _build_phase_b(
    launch: str, sweep_calls: int, geom: Geometry = Geometry()
):
    """Packing sweep over the (rare) hit launches + fused word extraction.

    One jit: scan the packing launch over the hit launches, flatten every
    packed adjacency word, sized-nonzero the nonzero WORDS (32x fewer
    elements than bit-expansion — jnp.nonzero lowers to a sort), gather
    their values, and return [loc | val | total] in one small array so a
    phase-B batch costs a single dispatch and a single small fetch.

    With the per-tile driver, ``geom`` is the BAND_TILES=1 repack
    geometry: each "launch" is ONE hit tile, not a 16-tile stripe.
    """
    import jax
    import jax.numpy as jnp

    chunk_fn = _build_chunk(launch, geom)

    @jax.jit
    def run(scalars_all, rows_pm, cols_pm, bounds, row_lo):
        def body(_, scal):
            packed, _ = chunk_fn(scal, rows_pm, cols_pm, bounds, row_lo)
            return None, packed

        _, packed_all = jax.lax.scan(body, None, scalars_all)
        flat = packed_all.reshape(-1)
        if PHASE_B_V2:
            # two-level: one fused pass reduces words to per-1024-row
            # nonzero counts, a tiny sized-nonzero finds the hot rows,
            # one row gather pulls them, and the word-level sized
            # nonzero runs over HOT_ROWS * 1024 words instead of the
            # whole batch
            rows = flat.reshape(-1, 1024)
            rownz = jnp.sum((rows != 0).astype(jnp.int32), axis=1)
            hot = jnp.nonzero(
                rownz > 0, size=PHASE_B_HOT_ROWS, fill_value=-1
            )[0].astype(jnp.int32)
            hot_total = jnp.sum((rownz > 0).astype(jnp.int32))
            sub = jnp.take(rows, jnp.maximum(hot, 0), axis=0)
            sub = jnp.where((hot >= 0)[:, None], sub, 0)
            sub_flat = sub.reshape(-1)
            nz = sub_flat != 0
            total = jnp.sum(nz.astype(jnp.int32))
            loc2 = jnp.nonzero(
                nz, size=EXTRACT_WORD_CAP, fill_value=-1
            )[0].astype(jnp.int32)
            val = jnp.take(sub_flat, jnp.maximum(loc2, 0))
            loc = jnp.where(
                loc2 >= 0,
                jnp.take(hot, jnp.maximum(loc2, 0) // 1024) * 1024
                + loc2 % 1024,
                -1,
            ).astype(jnp.int32)
            # hot-row overflow: missed words exist beyond the gathered
            # rows — inflate total past the cap so the decoder takes the
            # exact per-launch fallback
            overflow = (hot_total > PHASE_B_HOT_ROWS).astype(jnp.int32)
            total = total + overflow * (EXTRACT_WORD_CAP + 1)
            return jnp.concatenate([loc, val, total[None]])
        nz = flat != 0
        total = jnp.sum(nz.astype(jnp.int32))
        loc = jnp.nonzero(nz, size=EXTRACT_WORD_CAP, fill_value=-1)[0]
        loc = loc.astype(jnp.int32)
        val = jnp.take(flat, jnp.maximum(loc, 0))
        return jnp.concatenate([loc, val, total[None]])

    return run


def _decode_phase_b(
    arr: np.ndarray,
    sweep_calls: int,
    batch: list[tuple[int, tuple[int, ...]]],
    out_i: list[np.ndarray],
    out_j: list[np.ndarray],
    geom: Geometry = Geometry(),
) -> bool:
    """Host decode of one phase-B result ([loc | val | total]): word
    locations + values -> global (row, col) pairs appended to out_i/out_j.
    Returns False on word-capacity overflow (caller falls back)."""
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    cap = EXTRACT_WORD_CAP
    loc = arr[:cap]
    val = arr[cap : 2 * cap].astype(np.int64) & 0xFFFFFFFF
    total = int(arr[-1])
    valid = loc >= 0
    if total > int(valid.sum()):
        return False
    loc = loc[valid].astype(np.int64)
    val = val[valid]
    if loc.size == 0:
        return True
    # packed_all layout: [launch, R_TILES, BAND_TILES, TILE_M//32, TILE_N];
    # bit b of word [k, i, j, r, c] = pair (row r*32+b, col c) of tile
    # (i, j) of launch k
    shape = (sweep_calls, R_TILES, BAND_TILES, TILE_M // 32, TILE_N)
    k, i, j, r, c = np.unravel_index(loc, shape)
    keep = k < len(batch)  # drop padding launches
    k, i, j, r, c, val = (
        k[keep], i[keep], j[keep], r[keep], c[keep], val[keep]
    )
    if k.size == 0:
        return True
    rt0s = np.array([b[0] for b in batch], dtype=np.int64)
    cts = np.array([b[1] for b in batch], dtype=np.int64)
    rbase = (rt0s[k] + i) * TILE_M + r * 32
    cbase = (cts[k, i] + j) * TILE_N + c
    bits = (val[:, None] >> np.arange(32, dtype=np.int64)[None, :]) & 1
    ww, bb = np.nonzero(bits)
    out_i.append(rbase[ww] + bb)
    out_j.append(cbase[ww])
    return True


def _plan_launches(state) -> list[tuple[int, tuple[int, ...]]]:
    """Enumerate every launch descriptor (first row tile, per-row-tile
    first column tile), covering each row tile's whole duration band in
    BAND_TILES stripes."""
    TILE_M, TILE_N, R_TILES, BAND_TILES = state.geom
    launches: list[tuple[int, tuple[int, ...]]] = []
    max_ct = state.max_ct
    clamp = int(max_ct - BAND_TILES)
    if R_TILES == 1:
        # fast path: plain-int loop (2.8M launches at 16M hashes — the
        # per-stripe NumPy ops of the general path cost ~10x more)
        first_ct = state.first_ct
        n_ct = state.n_ct
        for rt in range(state.n_row_chunks):
            nc = int(n_ct[rt])
            if nc <= 0:
                continue
            ct0 = int(first_ct[rt])
            launches.extend(
                (rt, (min(ct0 + s, clamp),))
                for s in range(0, nc, BAND_TILES)
            )
        return launches
    for chunk_idx in range(state.n_row_chunks):
        rt0 = chunk_idx * R_TILES
        rts = np.arange(rt0, rt0 + R_TILES)
        remaining = state.n_ct[rts].copy()
        starts = state.first_ct[rts].copy()
        while np.any(remaining > 0):
            # rows whose band is exhausted keep pointing past their band
            # end (clamped in-bounds): the col_ids < bounds mask empties
            # them.
            cur = np.minimum(starts, clamp).astype(np.int64)
            launches.append((rt0, tuple(int(c) for c in cur)))
            starts = starts + BAND_TILES
            remaining = remaining - BAND_TILES
    return launches


def _gen_batches(state, launches, sweep_sizes):
    """Yield (launch batch, window start row | None).

    Resident states batch by count alone (largest precompiled size that
    the remainder fills — padded launches run their full dot work for
    nothing).  Windowed states additionally cut a batch when its
    row+band span would leave the resident +/-1 window."""
    TILE_M, TILE_N, R_TILES, BAND_TILES = state.geom
    if not getattr(state, "windowed", False):
        b0 = 0
        while b0 < len(launches):
            rem = len(launches) - b0
            size = next(
                (s for s in sweep_sizes if s <= rem), sweep_sizes[-1]
            )
            yield launches[b0 : b0 + size], None
            b0 += min(size, rem)
    elif getattr(state, "split", False):
        # split-window states: a batch must fit BOTH windows — the row
        # chunk inside the (statically positioned) rows window, the
        # launch's column stripe inside the (dynamically anchored) cols
        # window.  The caller sorted launches by (rows window, column),
        # so both windows advance monotonically within their loops.
        rw = state.rows_window_rows
        cw = state.window_rows
        align = state.window_align
        total = int(state.packed_dev.shape[0])
        rmax = total - rw
        wmax = total - cw
        max_batch = sweep_sizes[0]
        i = 0
        cur: tuple[int, int] | None = None
        while i < len(launches):
            batch: list[tuple[int, tuple[int, ...]]] = []
            for _attempt in range(2):
                while i < len(launches) and len(batch) < max_batch:
                    rt0, cts = launches[i]
                    r_start = min(rt0 * TILE_M // rw * rw, rmax)
                    lo_edge = min(cts) * TILE_N
                    end = (max(cts) + BAND_TILES) * TILE_N
                    if (
                        cur is None
                        or r_start != cur[0]
                        or lo_edge < cur[1]
                        or end - cur[1] > cw
                    ):
                        break
                    batch.append(launches[i])
                    i += 1
                if batch or i >= len(launches):
                    break
                rt0, cts0 = launches[i]
                cur = (
                    min(rt0 * TILE_M // rw * rw, rmax),
                    min(min(cts0) * TILE_N // align * align, wmax),
                )
            assert batch, "single launch exceeds the split window spans"
            yield batch, cur
    else:
        w_rows = state.window_rows
        align = state.window_align
        wmax = int(state.packed_dev.shape[0]) - w_rows
        max_batch = sweep_sizes[0]
        rows_static = getattr(state, "rows_static", False)
        i = 0
        w_start: int | None = None
        while i < len(launches):
            batch: list[tuple[int, tuple[int, ...]]] = []
            for _attempt in range(2):
                while i < len(launches) and len(batch) < max_batch:
                    rt0, cts = launches[i]
                    if rows_static:
                        # rows are resident (refs): only the launch's
                        # COLUMN stripe must lie inside the window
                        lo_edge = min(cts) * TILE_N
                        end = (max(cts) + BAND_TILES) * TILE_N
                    else:
                        lo_edge = rt0 * TILE_M
                        end = max(
                            (rt0 + R_TILES) * TILE_M,
                            (max(cts) + BAND_TILES) * TILE_N,
                        )
                    if (
                        w_start is None
                        or lo_edge < w_start
                        or end - w_start > w_rows
                    ):
                        break
                    batch.append(launches[i])
                    i += 1
                if batch or i >= len(launches):
                    break
                # current window exhausted: reposition it at this
                # launch's chunk (the window is REUSED across batches
                # until then — repositioning per batch would force a
                # drain + rebuild every few thousand rows)
                rt0, cts0 = launches[i]
                anchor = (
                    min(cts0) * TILE_N if rows_static else rt0 * TILE_M
                )
                w_start = min((anchor // align) * align, wmax)
            assert batch, "single launch exceeds the window span"
            yield batch, w_start


def _fill_scalars(
    scalars_all: np.ndarray,
    batch: list[tuple[int, tuple[int, ...]]],
    state,
    tolerance_int: int,
    n: int,
    w_start: int | None,
) -> None:
    """Launch scalars for one batch; padding rows keep tol=-1 (impossible
    threshold -> no matches)."""
    TILE_M, TILE_N, R_TILES, _BAND_TILES = state.geom
    # rows_static states (windowed refs search) keep the whole rows
    # operand resident — only the COLUMN window slides, so row-tile
    # indices are absolute while column tiles are window-relative
    rows_static = getattr(state, "rows_static", False)
    if isinstance(w_start, tuple):
        # split-window state: independent rows/cols window bases
        w_tm = w_start[0] // TILE_M
        w_tn = w_start[1] // TILE_N
    else:
        w_tm = 0 if (w_start is None or rows_static) else w_start // TILE_M
        w_tn = 0 if w_start is None else w_start // TILE_N
    scalars_all[:, 0] = -1
    k = len(batch)
    rt0s = np.fromiter((b[0] for b in batch), np.int64, count=k)
    cts = np.array([b[1] for b in batch], dtype=np.int64).reshape(
        k, R_TILES
    )
    scalars_all[:k, 0] = tolerance_int
    scalars_all[:k, 1] = n
    scalars_all[:k, 2] = rt0s - w_tm
    scalars_all[:k, 3 : 3 + R_TILES] = cts - w_tn
    idx = rt0s[:, None] + np.arange(R_TILES)
    scalars_all[:k, 3 + R_TILES : 3 + 2 * R_TILES] = state.min_bound[idx]
    scalars_all[:k, 3 + 2 * R_TILES : 3 + 3 * R_TILES] = (
        state.max_row_lo[idx]
    )
    scalars_all[:k, 3 + 3 * R_TILES] = w_tn
    # row-window base: >= 0 selects the in-kernel iota row_lo (global
    # row index, the self-search); -1 reads the row_lo operand (refs)
    scalars_all[:k, 4 + 3 * R_TILES] = (
        w_tm if getattr(state, "row_lo_iota", True) else -1
    )



@functools.cache
def _unpack_jit():
    import jax
    import jax.numpy as jnp

    @jax.jit
    def f(p):
        k = p.shape[0]
        shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
        bits = (p[:, :, None] >> shifts) & jnp.uint32(1)
        pm = bits.astype(jnp.int8).reshape(k, HASH_BITS_PADDED) * 2 - 1
        return pm if PM_DTYPE == "int8" else pm.astype(jnp.bfloat16)

    return f


def unpack_pm1_device(packed):
    """uint32[K, 32] -> PM_DTYPE[K, 1024] over {-1, +1} (jitted ONCE —
    rebuilding the jit per call retraced and re-deserialized the
    persistent-cache entry every time)."""
    return _unpack_jit()(packed)


def _tile_bits_to_pairs(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int32[TILE_M//32, TILE_N] transposed words -> (row_off, col_off)."""
    u = np.ascontiguousarray(words).view(np.uint32)
    # bit b of u[r, c] = adjacency of (row r*32+b, col c)
    bits = (
        (u[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    ).astype(bool)  # [TILE_M//32, 32, TILE_N]
    rr, bb, cc = np.nonzero(bits)
    return rr * 32 + bb, cc


def _launch_metadata(
    n: int, bounds: np.ndarray, n_row_chunks: int, geom: Geometry
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per row tile: first col tile of the band, number of col tiles, and
    the per-tile window extrema."""
    TILE_M, TILE_N, R_TILES, _BAND_TILES = geom
    n_tiles = n_row_chunks * R_TILES
    first_ct = np.zeros(n_tiles, dtype=np.int64)
    n_ct = np.zeros(n_tiles, dtype=np.int64)
    min_bound = np.zeros(n_tiles, dtype=np.int64)
    max_row_lo = np.full(n_tiles, _ROW_LO_SENTINEL, dtype=np.int64)
    # vectorized per-tile reduction (a Python loop here is 16k iterations
    # at 16M hashes, paid on every cold state build): full tiles reduce
    # in one reshape, the partial tail tile separately; tiles past n keep
    # the (0, 0, 0, sentinel) defaults
    bounds_c = np.asarray(bounds[:n], dtype=np.int64)
    nt_used = min(-(-n // TILE_M), n_tiles) if n else 0
    if nt_used:
        nt_full = min(n // TILE_M, n_tiles)
        cmax = np.empty(nt_used, np.int64)
        cmin = np.empty(nt_used, np.int64)
        if nt_full:
            resh = bounds_c[: nt_full * TILE_M].reshape(-1, TILE_M)
            cmax[:nt_full] = resh.max(axis=1)
            cmin[:nt_full] = resh.min(axis=1)
            # full tiles: no pad-row sentinels
            max_row_lo[:nt_full] = (
                np.arange(1, nt_full + 1, dtype=np.int64) * TILE_M - 1
            )
        if nt_used > nt_full:  # partial tail tile
            cmax[nt_full] = bounds_c[nt_full * TILE_M :].max()
            cmin[nt_full] = bounds_c[nt_full * TILE_M :].min()
        r0 = np.arange(nt_used, dtype=np.int64) * TILE_M
        ct0 = (r0 + 1) // TILE_N
        first_ct[:nt_used] = ct0
        n_ct[:nt_used] = np.maximum(
            0, -(-(cmax - ct0 * TILE_N) // TILE_N)
        )
        min_bound[:nt_used] = np.minimum(cmin, n)
    return first_ct, n_ct, min_bound, max_row_lo


class PallasSearchState:
    """Device-resident search state, reusable across sweeps.

    Separates the one-time cost (h2d upload of the packed matrix + on-device
    unpack to +/-1 bf16) from the per-search sweep: in the full pipeline the
    hash matrix is born on device, and repeated searches (e.g. tolerance
    sweeps) shouldn't re-upload 128 B/hash each time.

    ``pm1_dev`` (uint32[n_pad, 32] already on device, duration-sorted) can
    replace the host ``packed`` — the incremental-library path, where only
    new rows ride h2d and the sort is a device gather.
    """

    row_lo_iota = True  # self-search: in-kernel iota row_lo

    def __init__(
        self,
        packed: np.ndarray | None,
        bounds: np.ndarray,
        n: int | None = None,
        packed_dev=None,
        defer_upload: bool = False,
        geom: Geometry | None = None,
    ) -> None:
        import jax.numpy as jnp

        self.geom = geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        if n is None:
            assert packed is not None
            n = packed.shape[0]
        bounds = np.asarray(bounds, dtype=np.int64)
        n_row_tiles = -(-n // TILE_M)
        n_row_chunks = -(-n_row_tiles // R_TILES)
        n_pad = n_row_chunks * R_TILES * TILE_M + (BAND_TILES + 1) * TILE_N
        self.uploaded_rows: int | None = None
        if packed_dev is not None:
            assert packed_dev.shape[0] >= n_pad
            self.pm1 = unpack_pm1_device(packed_dev[:n_pad])
        elif defer_upload:
            # streamed build: the duration band is near-diagonal, so the
            # sweep can start as soon as each row prefix is resident —
            # ensure_rows() uploads chunk-by-chunk and the sweep driver
            # interleaves the h2d with the counts sweep.
            stream_rows = int(
                os.environ.get("VDF_STREAM_CHUNK_ROWS", "131072")
            )
            stream_rows = min(stream_rows, -(-n_pad // 256) * 256)
            n_chunks = -(-n_pad // stream_rows)
            total = n_chunks * stream_rows
            self._host_pad = np.zeros((total, packed.shape[1]), np.uint32)
            self._host_pad[:n] = packed
            self._stream_rows = stream_rows
            pm_dt = jnp.int8 if PM_DTYPE == "int8" else jnp.bfloat16
            self.pm1 = jnp.zeros((total, HASH_BITS_PADDED), pm_dt)
            self.uploaded_rows = 0
        else:
            packed_pad = np.zeros((n_pad, packed.shape[1]), dtype=np.uint32)
            packed_pad[:n] = packed
            self.pm1 = unpack_pm1_device(jnp.asarray(packed_pad))
        if not defer_upload:
            self.pm1.block_until_ready()

        bounds_dev_np = np.full((n_pad, 1), -1, dtype=np.int32)
        bounds_dev_np[:n, 0] = np.minimum(bounds, n)
        self.bounds_dev = jnp.asarray(bounds_dev_np)

        # self-search row_lo (j > i) is computed in the launch from an
        # iota (row_lo_iota); the operand slot aliases bounds
        self.row_lo_dev = self.bounds_dev

        # per row tile: first col tile of the band, number of col tiles,
        # and the window extrema
        first_ct, n_ct, min_bound, max_row_lo = _launch_metadata(
            n, bounds, n_row_chunks, geom
        )
        self.n = n
        self.n_pad = n_pad
        self.n_row_chunks = n_row_chunks
        self.first_ct = first_ct
        self.n_ct = n_ct
        self.min_bound = min_bound
        self.max_row_lo = max_row_lo
        self.max_ct = (n_pad - TILE_N) // TILE_N

    def ensure_rows(self, rows_needed: int) -> None:
        """Streamed build: upload chunks until ``rows_needed`` rows of the
        +/-1 matrix are resident (no-op for eagerly built states).

        Uploads run inline on the driver thread, between sweep
        dispatches."""
        if self.uploaded_rows is None:
            return
        import jax.numpy as jnp

        total = self._host_pad.shape[0]
        rows_needed = min(rows_needed, total)
        update = _stream_update_jit()
        while self.uploaded_rows < rows_needed:
            a = self.uploaded_rows
            b = a + self._stream_rows
            chunk = jnp.asarray(self._host_pad[a:b])
            self.pm1 = update(self.pm1, chunk, jnp.int32(a))
            self.uploaded_rows = b


@functools.cache
def _stream_update_jit():
    import jax

    # no donation: in-flight sweep batches still read the previous pm1
    # buffer, and donating it would invalidate their handle
    @jax.jit
    def f(pm1, chunk_packed, at):
        # whole-chunk unpack (one scan step): the operand arrives by h2d,
        # not via a dynamic_slice, so no broadcast temp materializes
        pm = unpack_pm_scan(chunk_packed, chunk_packed.shape[0])
        return jax.lax.dynamic_update_slice(pm1, pm, (at, 0))

    return f


@functools.cache
def _incremental_jits():
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, donate_argnums=(0,))
    def update_rows(buf, rows, at):
        # donated: appends write in place, no 128 B/hash re-copy
        return jax.lax.dynamic_update_slice(buf, rows, (at, 0))

    @jax.jit
    def gather_rows(buf, idx):
        return jnp.take(buf, idx, axis=0, mode="clip")

    return update_rows, gather_rows


class IncrementalDeviceLibrary:
    """Append-only device-resident packed-hash store.

    Rows live on device in INSERTION order; ``append`` uploads only the
    new rows (128 B/hash h2d, into a donated buffer).  ``state`` then
    materializes a duration-sorted ``PallasSearchState`` via a device
    gather — the cache-update-then-search flow no longer re-uploads the
    whole matrix per update.  Rows gathered past
    ``n`` (tile padding) may be garbage: every kernel masks pad rows and
    columns by id/bounds, so their distances never become pairs.
    """

    def __init__(self, capacity: int = 4096) -> None:
        import jax.numpy as jnp

        self._cap = max(1024, int(capacity))
        if self._cap * 128 > _max_alloc_bytes():
            # past the single-allocation watermark: chunked store
            store = ChunkedPackedStore.zeros(self._cap)
            self._cap = store.shape[0]
            self._packed = store
        else:
            self._packed = jnp.zeros((self._cap, 32), jnp.uint32)
        self.n = 0
        self._shared = False  # a state holds a zero-copy view of _packed

    def _grow(self, need: int) -> None:
        import jax.numpy as jnp

        if isinstance(self._packed, ChunkedPackedStore):
            # chunk granularity already amortizes growth; existing
            # chunks are reused untouched (shallow-copy the list if a
            # state shares it so its view keeps the old length)
            store = self._packed
            if self._shared:
                store = ChunkedPackedStore(
                    list(store.chunks), store.chunk_rows
                )
            store.extend_to(need)
            self._packed = store
            self._cap = store.shape[0]
            self._shared = False
            return
        new_cap = self._cap
        while new_cap < need:
            new_cap *= 2
        if new_cap * 128 > _max_alloc_bytes() / 2:
            # crossing HALF the single-allocation watermark: migrate to
            # a chunked store NOW, while the flat source plus its
            # chunk-sized copies still fit beside each other.  Waiting
            # for the full watermark migrates from a flat buffer whose
            # source + destination + copy temps can exceed the device —
            # the bare OOM this class exists to prevent.
            self._migrate_to_chunked(need)
            return
        buf = jnp.zeros((new_cap, 32), jnp.uint32)
        update_rows, _ = _incremental_jits()
        self._packed = update_rows(
            buf, self._packed[: self.n], jnp.int32(0)
        )
        self._cap = new_cap
        self._shared = False

    def _migrate_to_chunked(self, need: int) -> None:
        """Migrate the flat packed buffer into a ``ChunkedPackedStore``
        with bounded peak HBM.

        Chunks are built as chunk-sized device slices of the flat
        buffer (never a full-size copy, never a pre-zeroed full store),
        so the d2d path peaks at ~2x the flat bytes + one chunk.  A flat
        buffer already past half the watermark (only reachable via an
        explicit large ctor ``capacity``) bounces through the host
        instead — d2h chunk fetches, drop the flat buffer, re-upload —
        peaking at flat + one chunk on device; slower, but the d2d
        route would need ~2x flat + scratch, past total HBM.
        """
        import jax.numpy as jnp

        check_packed_capacity(need, "chunked packed store")
        cr = fit_chunk_rows(max(need, int(self._packed.shape[0])))
        flat = self._packed
        rows_total = int(flat.shape[0])
        flat_bytes = rows_total * 128
        chunks = []
        if flat_bytes <= _max_alloc_bytes() / 2:
            at = 0
            while at < rows_total:
                take = min(cr, rows_total - at)
                chunks.append(
                    _chunk_slice1_jit(take)(flat, jnp.int32(at))
                )
                at += take
        else:
            import logging

            logging.getLogger(__name__).warning(
                "migrating a %.1f GiB flat device library through the"
                " host (chunked growth past the single-allocation"
                " watermark): expect one-off d2h+h2d transfer time",
                flat_bytes / 2**30,
            )
            host_pieces = []
            at = 0
            while at < rows_total:
                take = min(cr, rows_total - at)
                host_pieces.append(
                    np.asarray(
                        _chunk_slice1_jit(take)(flat, jnp.int32(at))
                    )
                )
                at += take
            # drop every device reference to the flat buffer before
            # re-uploading, so flat + chunks never coexist
            self._packed = flat = None
            chunks = [jnp.asarray(p) for p in host_pieces]
        store = ChunkedPackedStore(chunks, cr)
        flat = None  # last flat reference (d2d path) dies here
        self._packed = store  # data safe before the zero-extension
        store.extend_to(need)  # capacity pre-checked above
        self._cap = store.shape[0]
        self._shared = False

    def append(self, packed_rows: np.ndarray) -> None:
        import jax.numpy as jnp

        packed_rows = np.ascontiguousarray(packed_rows, dtype=np.uint32)
        k = packed_rows.shape[0]
        if k == 0:
            return
        if self.n + k > self._cap:
            self._grow(self.n + k)
        elif self._shared:
            # a zero-copy state references _packed: the donating in-place
            # append below would delete the buffer under it — copy first
            if isinstance(self._packed, ChunkedPackedStore):
                # chunks are immutable jnp arrays; a shallow list copy
                # suffices (set_rows rebinds entries in OUR list only)
                self._packed = ChunkedPackedStore(
                    list(self._packed.chunks), self._packed.chunk_rows
                )
            else:
                self._packed = jnp.array(self._packed)
            self._shared = False
        if isinstance(self._packed, ChunkedPackedStore):
            self._packed.set_rows(self.n, packed_rows)
        else:
            update_rows, _ = _incremental_jits()
            self._packed = update_rows(
                self._packed, jnp.asarray(packed_rows), jnp.int32(self.n)
            )
        self.n += k

    def state(
        self,
        order: np.ndarray,
        bounds: np.ndarray,
        windowed: bool | None = None,
        geom: Geometry | None = None,
        split: bool | None = None,
    ) -> "PallasSearchState | WindowedPallasState | SplitWindowState":
        """Duration-sorted search state for the current library.

        ``order``: permutation (insertion index per sorted position, the
        host's (duration, path) sort); ``bounds``: per sorted row, the
        exclusive upper bound of its duration window.  ``windowed``
        defaults to the ``platform.resident_rows`` rule (a sliding +/-1
        window instead of the 1 KB/hash resident matrix above it);
        ``split`` defaults to ``should_split`` (independent rows/cols
        windows once packed + the minimum single window exceed HBM).

        An IDENTITY ``order`` (rows appended pre-sorted) with enough
        capacity hands the library buffer to the state zero-copy — a
        gather would transiently hold two copies of the packed library.
        The next ``append`` copies before its donating
        in-place update so the state's view stays valid.
        """
        import jax.numpy as jnp

        geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        n = int(len(order))
        assert n <= self.n
        if windowed is None:
            windowed = n >= platform.resident_rows()
        if split is None:
            split = windowed and should_split(n, bounds, geom)
        # size to the STATE's real packed need (window slide-room
        # included), so the zero-copy check and the gather output never
        # force the constructor's pad concatenate, which transiently
        # doubles the packed buffer
        if split:
            n_pad = split_need(n, bounds, geom=geom)
        elif windowed:
            n_pad = windowed_need(n, bounds, geom=geom)
        else:
            n_row_tiles = -(-n // TILE_M)
            n_row_chunks = -(-n_row_tiles // R_TILES)
            n_pad = (
                n_row_chunks * R_TILES * TILE_M
                + (BAND_TILES + 1) * TILE_N
            )
        order_np = np.asarray(order, dtype=np.int64)
        chunked = isinstance(self._packed, ChunkedPackedStore)
        if (
            n == self.n
            # a chunked store extends itself with zero chunks inside the
            # state constructor, so its capacity never forces a gather
            and (self._cap >= n_pad or chunked)
            and np.array_equal(order_np, np.arange(n, dtype=np.int64))
        ):
            if chunked and not (windowed or split):
                raise ValueError(
                    f"library of {n} hashes is chunked past the "
                    f"single-allocation watermark "
                    f"({_max_alloc_bytes() / 2**30:.1f} GiB, "
                    f"VDF_MAX_ALLOC_GB) and requires a windowed state; "
                    f"do not force windowed=False at this scale"
                )
            if chunked:
                # hand the state its OWN store wrapper (shallow list
                # copy; the chunk arrays themselves are shared): the
                # state ctor extend_to()s window slide room, which must
                # not mutate the library's store in place or stale its
                # _cap.  Library appends rebind entries of the library's
                # own list (non-donating updates), so the state's copy
                # stays valid without the _shared dance.
                packed_sorted = ChunkedPackedStore(
                    list(self._packed.chunks), self._packed.chunk_rows
                )
            else:
                packed_sorted = self._packed  # zero-copy; pads masked
                self._shared = True
        elif chunked:
            # a cross-chunk permutation gather would transiently hold
            # source + destination stores (2 x 128 B/hash) plus gather
            # temps — past total HBM at every size that chunks.  The
            # zero-copy handoff above is the supported path here.
            raise ValueError(
                f"library of {self.n} hashes exceeds the single-"
                f"allocation watermark ({_max_alloc_bytes() / 2**30:.1f}"
                f" GiB, VDF_MAX_ALLOC_GB): append rows duration-sorted "
                f"(identity order over the full library) — an unsorted "
                f"handoff needs a permutation gather that cannot fit "
                f"HBM at this scale"
            )
        else:
            idx = np.zeros(n_pad, np.int32)
            idx[:n] = order_np
            _, gather_rows = _incremental_jits()
            packed_sorted = gather_rows(self._packed, jnp.asarray(idx))
        cls = (
            SplitWindowState
            if split
            else (WindowedPallasState if windowed else PallasSearchState)
        )
        return cls(None, bounds, n=n, packed_dev=packed_sorted, geom=geom)


@functools.cache
def _packed_update_jit():
    import jax
    import jax.numpy as jnp

    # no donation: queued window builds may still read the buffer
    @jax.jit
    def f(buf, chunk, at):
        return jax.lax.dynamic_update_slice(buf, chunk, (at, 0))

    return f


def _max_alloc_bytes() -> float:
    """Largest single packed buffer before the library switches to a
    ``ChunkedPackedStore``.  No limit unless ``VDF_MAX_ALLOC_GB`` (GiB)
    sets one: the flat store is the default on every backend."""
    v = os.environ.get("VDF_MAX_ALLOC_GB")
    return float(v) * 2**30 if v is not None else float("inf")


def _packed_cap_bytes() -> float:
    """Total packed-library bytes the device may hold, leaving room for
    the sweep's +/-1 windows and program scratch: 70% of the device's
    ``bytes_limit`` (a planning fraction, not measured on this card).
    ``VDF_PACKED_CAP_GB`` (1e9 bytes) overrides."""
    v = os.environ.get("VDF_PACKED_CAP_GB")
    if v is not None:
        return float(v) * 1e9
    return 0.7 * platform.bytes_limit()


def check_packed_capacity(total_rows: int, who: str = "packed library") -> None:
    """Raise a clear capacity error instead of letting a multi-GB
    allocation die deep inside the runtime with a bare
    RESOURCE_EXHAUSTED."""
    need = int(total_rows) * 128
    cap = _packed_cap_bytes()
    if need > cap:
        raise ValueError(
            f"{who} of {int(total_rows):,} hashes needs {need / 1e9:.2f} GB"
            f" packed, over the {cap / 1e9:.1f} GB device capacity budget."
            f"  Shard the library across devices (backend='ring') or set"
            f" VDF_PACKED_CAP_GB."
        )


def _default_chunk_rows() -> int:
    """Rows per chunk of a ``ChunkedPackedStore`` (default 16M rows =
    2 GiB).  Must be a multiple of the window alignment (lcm of the tile
    dims, 2048 at the production geometry) and at least as large as any
    sliding window so a window spans <= 2 adjacent chunks."""
    return int(os.environ.get("VDF_CHUNK_ROWS", str(16 * 2**20)))


@functools.cache
def _chunk_slice1_jit(w_rows: int):
    import jax

    @jax.jit
    def f(c, rel):
        return jax.lax.dynamic_slice(c, (rel, 0), (w_rows, 32))

    return f


@functools.cache
def _chunk_slice_k_jit(w_rows: int, chunk_rows: int, k: int):
    import jax
    import jax.numpy as jnp

    # window straddling k chunks: k bounded row gathers + selects (a
    # concatenate of the chunks would transiently hold k x chunk_bytes;
    # a clamped dynamic_slice would silently shift out-of-range starts).
    # ``rel`` is traced so every move at this window size reuses one
    # compile.
    @jax.jit
    def f(rel, *cs):
        idx = rel + jnp.arange(w_rows, dtype=jnp.int32)
        out = None
        for ci, c in enumerate(cs):
            local = idx - ci * chunk_rows
            g = jnp.take(
                c, jnp.clip(local, 0, chunk_rows - 1), axis=0
            )
            if out is None:
                out = g
            else:
                out = jnp.where((local >= 0)[:, None], g, out)
        return out

    return f


class ChunkedPackedStore:
    """Packed [n, 32] uint32 library split across fixed-size device
    chunks.

    Used once a flat buffer would pass the single-allocation watermark
    (``_max_alloc_bytes``, set by VDF_MAX_ALLOC_GB); splitting the store
    bounds every allocation at ``chunk_rows`` x 128 B while
    keeping the library fully device-resident.  Sliding windows
    (<= ~2M rows) slice across at most two adjacent chunks, so window
    rebuild cost is unchanged on the (common) single-chunk path and one
    bounded gather on the straddle path.  Capacity then scales to total
    device memory instead of the per-allocation cap.
    """

    ndim = 2

    def __init__(self, chunks: list, chunk_rows: int) -> None:
        self.chunk_rows = int(chunk_rows)
        self.chunks = list(chunks)
        # routing invariant: every chunk is exactly chunk_rows, except
        # the LAST, which may be shorter (trims up to chunk_bytes of
        # rounding waste — decisive at the total-HBM capacity edge)
        assert all(
            int(c.shape[0]) == self.chunk_rows for c in chunks[:-1]
        )
        assert int(chunks[-1].shape[0]) <= self.chunk_rows

    @classmethod
    def zeros(cls, total_rows: int, chunk_rows: int | None = None):
        import jax.numpy as jnp

        check_packed_capacity(total_rows, "chunked packed store")
        cr = int(chunk_rows or _default_chunk_rows())
        total = max(256, -(-int(total_rows) // 256) * 256)
        full, rem = divmod(total, cr)
        chunks = [jnp.zeros((cr, 32), jnp.uint32) for _ in range(full)]
        if rem or not chunks:
            chunks.append(jnp.zeros((max(rem, 256), 32), jnp.uint32))
        return cls(chunks, cr)

    @property
    def shape(self) -> tuple[int, int]:
        return (
            self.chunk_rows * (len(self.chunks) - 1)
            + int(self.chunks[-1].shape[0]),
            32,
        )

    @property
    def nbytes(self) -> int:
        return self.shape[0] * 128

    def block_until_ready(self) -> None:
        for c in self.chunks:
            c.block_until_ready()

    def extend_to(self, total_rows: int) -> None:
        """Grow the store to hold ``total_rows`` (zero rows appended).
        A short last chunk is padded back to full first so the uniform
        chunk routing stays valid."""
        import jax.numpy as jnp

        if self.shape[0] >= total_rows:
            return
        check_packed_capacity(total_rows, "chunked packed store")
        last = self.chunks[-1]
        if int(last.shape[0]) < self.chunk_rows:
            pad = jnp.zeros(
                (self.chunk_rows - int(last.shape[0]), 32), jnp.uint32
            )
            self.chunks[-1] = jnp.concatenate([last, pad], axis=0)
        while self.shape[0] < total_rows:
            short = total_rows - self.shape[0]
            if short < self.chunk_rows:
                self.chunks.append(
                    jnp.zeros(
                        (-(-short // 256) * 256, 32), jnp.uint32
                    )
                )
            else:
                self.chunks.append(
                    jnp.zeros((self.chunk_rows, 32), jnp.uint32)
                )

    def slice_rows(self, at: int, w_rows: int):
        """Device uint32[w_rows, 32] window starting at row ``at``.
        ``at`` is a host int (window moves are host-level events), so
        chunk routing is static; only the intra-chunk offset is traced."""
        import jax.numpy as jnp

        assert 0 <= at and at + w_rows <= self.shape[0]
        c = at // self.chunk_rows
        rel = at - c * self.chunk_rows
        if rel + w_rows <= self.chunk_rows:
            return _chunk_slice1_jit(w_rows)(
                self.chunks[c], jnp.int32(rel)
            )
        k = -(-(rel + w_rows) // self.chunk_rows)
        return _chunk_slice_k_jit(w_rows, self.chunk_rows, k)(
            jnp.int32(rel), *self.chunks[c : c + k]
        )

    def set_rows(self, at: int, rows) -> None:
        """Write ``rows`` (host or device uint32[k, 32]) at row ``at``,
        splitting across chunk boundaries as needed."""
        import jax.numpy as jnp

        rows = np.ascontiguousarray(rows, dtype=np.uint32) if isinstance(
            rows, np.ndarray
        ) else rows
        k = int(rows.shape[0])
        assert at + k <= self.shape[0]
        upd = _packed_update_jit()
        off = 0
        while off < k:
            c = (at + off) // self.chunk_rows
            rel = (at + off) - c * self.chunk_rows
            take = min(k - off, self.chunk_rows - rel)
            self.chunks[c] = upd(
                self.chunks[c],
                jnp.asarray(rows[off : off + take]),
                jnp.int32(rel),
            )
            off += take

    def take_rows(self, idx: np.ndarray) -> np.ndarray:
        """Host gather of a few rows (planted-cluster seeds etc.)."""
        import jax
        import jax.numpy as jnp

        idx = np.asarray(idx, dtype=np.int64)
        out = np.zeros((idx.size, 32), np.uint32)
        for c in range(len(self.chunks)):
            m = (idx >= c * self.chunk_rows) & (
                idx < (c + 1) * self.chunk_rows
            )
            if not m.any():
                continue
            rel = idx[m] - c * self.chunk_rows
            try:
                out[m] = np.asarray(
                    jnp.take(self.chunks[c], jnp.asarray(rel), axis=0)
                )
            except Exception as e:  # XlaRuntimeError has no stable type
                if "RESOURCE_EXHAUSTED" not in str(e):
                    raise
                # Near the device-memory ceiling the batched gather's
                # scratch may not fit.  Fall back to one dynamic_slice
                # per row — k is small (planted seeds).
                sl = jax.jit(
                    lambda a, i: jax.lax.dynamic_slice(a, (i, 0), (1, 32))
                )
                out[m] = np.concatenate(
                    [
                        np.asarray(sl(self.chunks[c], jnp.int32(int(r))))
                        for r in rel
                    ],
                    axis=0,
                )
        return out

    def scatter_rows(
        self, idx: np.ndarray, rows: np.ndarray, donate: bool = False
    ) -> None:
        """Scatter host rows at arbitrary indices.

        ``donate=True`` updates each touched chunk in place (no
        chunk-sized copy — decisive at the HBM capacity edge, where
        bench_scale plants clusters into a near-ceiling store) but
        DELETES the old chunk buffer: only safe while this store is the
        sole owner of its chunks.  Any store that has been handed out
        (``IncrementalDeviceLibrary.state()``, ``_grow`` shallow
        copies) shares chunk arrays with the recipient, so the default
        is a non-donating functional update.
        """
        import jax

        import jax.numpy as jnp

        idx = np.asarray(idx, dtype=np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.uint32)

        @functools.partial(
            jax.jit, donate_argnums=(0,) if donate else ()
        )
        def scat(c, ii, rr):
            return c.at[ii].set(rr)

        for c in range(len(self.chunks)):
            m = (idx >= c * self.chunk_rows) & (
                idx < (c + 1) * self.chunk_rows
            )
            if not m.any():
                continue
            self.chunks[c] = scat(
                self.chunks[c],
                jnp.asarray(idx[m] - c * self.chunk_rows),
                jnp.asarray(rows[m]),
            )


@functools.cache
def _window_build_pk_jit(w_rows: int):
    """``_window_build_jit`` with the packed window pre-sliced (the
    chunked-store path slices it across chunks first)."""
    import math

    import jax

    @jax.jit
    def f(pk, bounds_full, at):
        pm = unpack_pm_scan(pk, math.gcd(w_rows, 1024))
        b = jax.lax.dynamic_slice(
            bounds_full, (at // 128, 0), (w_rows // 128, 128)
        ).reshape(w_rows, 1)
        return pm, b

    return f


@functools.cache
def _unpack_window_jit(w_rows: int):
    import math

    import jax

    @jax.jit
    def f(pk):
        return unpack_pm_scan(pk, math.gcd(w_rows, 1024))

    return f


def unpack_pm_scan(pk, chunk: int):
    """uint32[K, 32] packed hashes -> PM_DTYPE[K, 1024] over {-1, +1},
    bit-expanded in ``chunk``-row chunks under ``lax.scan``.

    The one shared +/-1 unpack body for every windowed driver (single-chip
    window build, refs column window, streamed upload, ring and sharded-
    refs operands).  Chunking matters whenever ``pk`` comes out of a
    ``dynamic_slice``: the slice is a fusion barrier, so an unchunked
    bit-expansion MATERIALIZES the u32[K, 32, 32] broadcast temp — 11 GB
    at a 3M-row window.  ``chunk`` must divide ``K``; callers pick
    ``math.gcd(K, 1024..4096)``.
    """
    import jax
    import jax.numpy as jnp

    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]

    def body(_, pkc):
        bits = (pkc[:, :, None] >> shifts) & jnp.uint32(1)
        pm_c = (
            bits.astype(jnp.int8).reshape(chunk, HASH_BITS_PADDED) * 2 - 1
        )
        if PM_DTYPE != "int8":
            pm_c = pm_c.astype(jnp.bfloat16)
        return None, pm_c

    _, pm = jax.lax.scan(body, None, pk.reshape(-1, chunk, 32))
    return pm.reshape(pk.shape[0], HASH_BITS_PADDED)


@functools.cache
def _window_build_jit(w_rows: int):
    import jax

    @jax.jit
    def f(packed_dev, bounds_full, at):
        import math

        pk = jax.lax.dynamic_slice(packed_dev, (at, 0), (w_rows, 32))
        pm = unpack_pm_scan(pk, math.gcd(w_rows, 1024))
        # full-library row metadata is stored [n_pad//128, 128] (row r at
        # [r//128, r%128]); only the WINDOW is expanded to the [w, 1]
        # layout the launches read.
        b = jax.lax.dynamic_slice(
            bounds_full, (at // 128, 0), (w_rows // 128, 128)
        ).reshape(w_rows, 1)
        return pm, b

    return f


def _window_plan(
    n: int, bounds: np.ndarray, geom: Geometry
) -> tuple:
    """Shared windowed-state planning: padded row count, launch metadata,
    window alignment and the minimum legal SINGLE-window size (the widest
    row chunk's whole band span — with one window, every launch's rows
    AND its full column band must fit it; the split-window states escape
    this by decoupling rows from columns).  Returns (bounds_i64, n_pad,
    n_row_chunks, first_ct, n_ct, min_bound, max_row_lo, align, min_w).
    """
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    bounds = np.asarray(bounds, dtype=np.int64)
    n_row_tiles = -(-n // TILE_M)
    n_row_chunks = -(-n_row_tiles // R_TILES)
    n_pad = n_row_chunks * R_TILES * TILE_M + (BAND_TILES + 1) * TILE_N
    first_ct, n_ct, min_bound, max_row_lo = _launch_metadata(
        n, bounds, n_row_chunks, geom
    )
    align = int(np.lcm(TILE_M * R_TILES, TILE_N))
    # the compact [rows//128, 128] metadata packing needs 128-aligned
    # row counts (n_pad and every window size are align-multiples)
    assert align % 128 == 0 and n_pad % 128 == 0
    span = 0
    for rt in range(n_row_chunks * R_TILES):
        if n_ct[rt] <= 0:
            continue
        stripes = -(-int(n_ct[rt]) // BAND_TILES)
        last_ct = int(first_ct[rt]) + (stripes - 1) * BAND_TILES
        col_end = (last_ct + BAND_TILES) * TILE_N
        w0 = (rt * TILE_M // align) * align
        span = max(span, col_end - w0, (rt + 1) * TILE_M - w0)
    min_w = -(-span // align) * align
    return (bounds, n_pad, n_row_chunks, first_ct, n_ct, min_bound,
            max_row_lo, align, min_w)


def windowed_need(
    n: int,
    bounds: np.ndarray,
    window_rows: int | None = None,
    geom: Geometry | None = None,
) -> int:
    """Packed-matrix row count a ``WindowedPallasState`` will require
    (``n_pad`` + the resolved window).  Device-born library generators
    size their buffer with this so the state takes the no-copy path
    instead of a multi-GB pad ``concatenate`` (which transiently doubles
    the packed buffer)."""
    geom = geom if geom is not None else Geometry()
    (_b, n_pad, _c, _f, _n, _mb, _mr, align, min_w) = _window_plan(
        n, bounds, geom
    )
    if window_rows is None:
        window_rows = 2 * min_w
    w_rows = max(min_w, -(-int(window_rows) // align) * align)
    w_rows = min(w_rows, -(-n_pad // align) * align)
    return -(-n_pad // align) * align + w_rows


def _split_budget_bytes() -> float:
    """Device memory a split-window sweep may PLAN against (packed store +
    unpacked window operands + bounds): 7/8 of the device's
    ``bytes_limit``, leaving the rest to counts buffers and program
    scratch (a planning fraction, not measured on this card).
    ``VDF_SPLIT_BUDGET_GB`` overrides."""
    return platform.budget_bytes("VDF_SPLIT_BUDGET_GB", 0.875)


def hbm_budget_bytes() -> float:
    """Device memory the single-window and ring states may plan their
    resident operands against: 3/4 of the device's ``bytes_limit``,
    leaving headroom for counts buffers, window rebuild transients and
    the allocator (a planning fraction, not measured on this card).
    ``VDF_HBM_BUDGET_GB`` overrides."""
    return platform.budget_bytes("VDF_HBM_BUDGET_GB", 0.75)


def _split_plan_bytes(n_pad: int, align: int, rw: int, cw: int) -> int:
    """Projected device bytes of a split-window sweep at window sizes
    (rw, cw): the packed store (flat or chunked — both keep a short
    last allocation, so roundup waste is negligible), the two unpacked
    +/-1 operand windows, and the padded bounds array."""
    cap = -(-n_pad // align) * align
    need = cap + max(rw, cw)
    pm_b = 1024 if PM_DTYPE == "int8" else 2048
    return need * 128 + (rw + cw) * pm_b + need * 4


def fit_chunk_rows(total_rows: int, align: int = 2048) -> int:
    """Chunk size for a ``ChunkedPackedStore`` holding ``total_rows``:
    the default chunk count, but each chunk shrunk so the ceil-roundup
    waste is < ``align`` rows instead of up to a whole 2 GiB chunk
    (the default 16M-row chunks would round 101M rows up to 117M)."""
    cr_default = _default_chunk_rows()
    k = max(1, -(-int(total_rows) // cr_default))
    cr = -(-(-(-int(total_rows) // k)) // align) * align
    return max(cr, align)


def _resolve_split_windows(
    n_pad: int,
    align: int,
    rows_window_rows: int | None,
    cols_window_rows: int | None,
    geom: Geometry,
) -> tuple[int, int]:
    """Resolve the (rows, cols) window sizes of a split-window state:
    align-rounded, floored at one row chunk / one anchored launch stripe,
    capped at the padded library.

    When BOTH sizes are defaults (no explicit argument, no
    VDF_SPLIT_ROWS_WINDOW/VDF_SPLIT_COLS_WINDOW), they auto-shrink —
    halving together — until the projected sweep footprint
    (``_split_plan_bytes``) fits ``_split_budget_bytes``, so
    near-ceiling libraries pick launchable windows instead of dying
    RESOURCE_EXHAUSTED in the counts launch.  Explicit sizes are
    authoritative and never adjusted."""
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    auto = rows_window_rows is None and cols_window_rows is None and (
        "VDF_SPLIT_ROWS_WINDOW" not in os.environ
        and "VDF_SPLIT_COLS_WINDOW" not in os.environ
    )
    rw = int(
        rows_window_rows
        or int(os.environ.get("VDF_SPLIT_ROWS_WINDOW", str(1 << 20)))
    )
    cw = int(
        cols_window_rows
        or int(os.environ.get("VDF_SPLIT_COLS_WINDOW", str(1 << 21)))
    )
    # a launch stripe spans BAND_TILES column tiles; its window anchor is
    # align-floored, so the column window must absorb one extra align
    min_cw = align + (BAND_TILES + 1) * TILE_N
    min_cw = -(-min_cw // align) * align
    rw = max(align, -(-rw // align) * align)
    cw = max(min_cw, -(-cw // align) * align)
    cap = -(-n_pad // align) * align
    rw, cw = min(rw, cap), min(cw, cap)
    if auto:
        budget = _split_budget_bytes()
        while _split_plan_bytes(n_pad, align, rw, cw) > budget and (
            rw > align or cw > min_cw
        ):
            rw = max(align, -(-(rw // 2) // align) * align)
            cw = max(min_cw, -(-(cw // 2) // align) * align)
    return rw, cw


def split_need(
    n: int,
    bounds: np.ndarray,
    rows_window_rows: int | None = None,
    cols_window_rows: int | None = None,
    geom: Geometry | None = None,
) -> int:
    """Packed-matrix row count a ``SplitWindowState`` will require (the
    split-window analogue of ``windowed_need``)."""
    geom = geom if geom is not None else Geometry()
    (_b, n_pad, _c, _f, _n, _mb, _mr, align, _mw) = _window_plan(
        n, bounds, geom
    )
    rw, cw = _resolve_split_windows(
        n_pad, align, rows_window_rows, cols_window_rows, geom
    )
    return -(-n_pad // align) * align + max(rw, cw)


def should_split(
    n: int,
    bounds: np.ndarray,
    geom: Geometry | None = None,
) -> bool:
    """Auto rule: does the single-window state's device footprint
    (packed 128 B/hash + the MINIMUM legal +/-1 window at 1 KB/row)
    exceed ``hbm_budget_bytes``?  Above it the split-window state is the
    only layout that fits — its windows are size-free knobs, not
    band-span-bound.  ``VDF_FORCE_SPLIT=1/0`` overrides."""
    force = os.environ.get("VDF_FORCE_SPLIT")
    if force is not None:
        return force == "1"
    geom = geom if geom is not None else Geometry()
    (_b, n_pad, _c, _f, _n, _mb, _mr, align, min_w) = _window_plan(
        n, bounds, geom
    )
    need = -(-n_pad // align) * align + min_w
    footprint = need * 128 + min_w * (
        1024 if PM_DTYPE == "int8" else 2048
    )
    return footprint > hbm_budget_bytes()


class WindowedPallasState:
    """Sliding-window search state: libraries beyond the resident +/-1
    budget.

    The resident +/-1 operand matrix costs 1 KB/hash (int8 x 1024 bits).
    Here only the PACKED library
    (128 B/hash) is fully device-resident; the +/-1 matrix exists for a
    SLIDING row window.  The duration band is near-diagonal (sorted
    durations), so every launch's rows AND its whole column band fit in a
    window that is a small multiple of the widest band span.  The sweep
    driver slides the window forward as its row cursor advances (each row
    is unpacked ~window/(window-span) ~= 2 times in total — noise next to
    the O(n * band) sweep) and passes window-RELATIVE tile indices to the
    launches; absolute column ids for the masks ride the wbase scalar.

    Same driver contract as ``PallasSearchState``; requires R_TILES == 1.
    """

    windowed = True
    row_lo_iota = True
    uploaded_rows = None  # the streamed-upload path does not apply

    def __init__(
        self,
        packed: np.ndarray | None,
        bounds: np.ndarray,
        n: int | None = None,
        packed_dev=None,
        window_rows: int | None = None,
        geom: Geometry | None = None,
    ) -> None:
        import jax.numpy as jnp

        self.geom = geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        assert R_TILES == 1, "windowed sweeps assume single-row-tile chunks"
        if n is None:
            assert packed is not None
            n = packed.shape[0]
        (bounds, n_pad, n_row_chunks, first_ct, n_ct, min_bound,
         max_row_lo, align, min_w) = _window_plan(n, bounds, geom)

        if packed_dev is not None:
            if isinstance(packed_dev, ChunkedPackedStore):
                packed_dev.extend_to(n_pad)
            assert packed_dev.shape[0] >= n_pad
        self.packed_dev = packed_dev  # None: deferred upload, sized below

        bounds_np = np.full(n_pad, -1, dtype=np.int32)
        bounds_np[:n] = np.minimum(bounds, n)

        # window sizing: every single launch (one row tile + its whole
        # BAND_TILES column stripe, anywhere in its band) must fit
        self.window_align = align
        if window_rows is None:
            window_rows = 2 * min_w
        w_rows = max(min_w, -(-int(window_rows) // align) * align)
        self.window_rows = min(w_rows, -(-n_pad // align) * align)
        # the device slice must stay in bounds: pad the packed matrix up
        # to a whole number of windows past n_pad
        need = -(-n_pad // align) * align + self.window_rows
        if packed_dev is None:
            # host-sourced library: DEFER the h2d — upload packed chunks
            # as the window advances (move_window triggers it), so a cold
            # large-N search overlaps its upload with the sweep instead
            # of blocking on one multi-GB transfer up front
            self._chunk = min(
                int(os.environ.get("VDF_STREAM_CHUNK_ROWS", "131072")),
                -(-need // 256) * 256,
            )
            total = -(-need // self._chunk) * self._chunk
            host_pad = np.zeros((total, 32), dtype=np.uint32)
            host_pad[:n] = packed
            self._host_packed: np.ndarray | None = host_pad
            self._uploaded_packed: int | None = 0
            if total * 128 > _max_alloc_bytes():
                # past the single-allocation watermark: chunked store
                self.packed_dev = ChunkedPackedStore.zeros(total)
            else:
                self.packed_dev = jnp.zeros((total, 32), jnp.uint32)
        else:
            self._host_packed = None
            self._uploaded_packed = None
            if packed_dev.shape[0] < need:
                if isinstance(packed_dev, ChunkedPackedStore):
                    packed_dev.extend_to(need)
                    self.packed_dev = packed_dev
                else:
                    pad = jnp.zeros(
                        (need - packed_dev.shape[0], 32), jnp.uint32
                    )
                    self.packed_dev = jnp.concatenate(
                        [packed_dev, pad], axis=0
                    )
        if bounds_np.size < need:
            bounds_np = np.concatenate(
                [bounds_np, np.full(need - n_pad, -1, np.int32)]
            )
        self._bounds_full = jnp.asarray(bounds_np.reshape(-1, 128))

        self.n = n
        self.n_pad = n_pad
        self.n_row_chunks = n_row_chunks
        self.first_ct = first_ct
        self.n_ct = n_ct
        self.min_bound = min_bound
        self.max_row_lo = max_row_lo
        self.max_ct = (n_pad - TILE_N) // TILE_N
        self.w0: int | None = None
        self.pm1 = None
        self.bounds_dev = None
        self.row_lo_dev = None
        self.rebuilds = 0

    def _ensure_packed(self, rows_needed: int) -> None:
        """Deferred-upload states: make packed rows [0, rows_needed)
        device-resident (chunked h2d that overlaps the sweep of earlier
        windows).  No-op once fully uploaded or for device-born states."""
        if self._uploaded_packed is None:
            return
        import jax.numpy as jnp

        total = self._host_packed.shape[0]
        rows_needed = min(
            -(-max(rows_needed, 0) // self._chunk) * self._chunk, total
        )
        upd = _packed_update_jit()
        chunked = isinstance(self.packed_dev, ChunkedPackedStore)
        while self._uploaded_packed < rows_needed:
            a = self._uploaded_packed
            if chunked:
                self.packed_dev.set_rows(
                    a, self._host_packed[a : a + self._chunk]
                )
            else:
                chunk = jnp.asarray(
                    self._host_packed[a : a + self._chunk]
                )
                self.packed_dev = upd(
                    self.packed_dev, chunk, jnp.int32(a)
                )
            self._uploaded_packed = a + self._chunk
        if self._uploaded_packed >= total:
            self._host_packed = None
            self._uploaded_packed = None

    def move_window(self, w_start: int) -> None:
        """Slide the resident +/-1 window to start at row ``w_start``
        (window_align-aligned).  The caller must ensure no launches are
        still in flight against the previous window (drain counts /
        block on the last dispatch) — otherwise BOTH windows stay live
        in HBM and large libraries OOM during the rebuild."""
        import jax.numpy as jnp

        assert w_start % self.window_align == 0
        self._ensure_packed(w_start + self.window_rows)
        # release our references first so the allocator can reuse the
        # previous window's pages for the new one
        self.pm1 = self.bounds_dev = self.row_lo_dev = None
        if isinstance(self.packed_dev, ChunkedPackedStore):
            pk = self.packed_dev.slice_rows(w_start, self.window_rows)
            self.pm1, self.bounds_dev = _window_build_pk_jit(
                self.window_rows
            )(pk, self._bounds_full, jnp.int32(w_start))
            del pk
        else:
            fn = _window_build_jit(self.window_rows)
            self.pm1, self.bounds_dev = fn(
                self.packed_dev,
                self._bounds_full,
                jnp.int32(w_start),
            )
        # iota row_lo: the operand slot aliases bounds (never read)
        self.row_lo_dev = self.bounds_dev
        self.w0 = w_start
        self.rebuilds += 1


class SplitWindowState:
    """Split-window search state: rows and columns slide INDEPENDENTLY.

    ``WindowedPallasState``'s single window must hold a row chunk AND its
    whole duration band, so its minimum size is the widest band span —
    which grows with the library and, added to the 128 B/hash packed
    matrix, eventually overflows the device.  Here the launch's two operand
    slots
    (already separate arguments with separate scalar-indexed windows —
    the windowed REFS state exploits the same structure) are fed from
    two small independent windows:

      * a rows window (``rows_window_rows``, default 1M ≈ 1 GB): +/-1
        rows, bounds and the aliased row_lo for the row chunks currently
        being swept, at STATIC positions (each row chunk belongs to
        exactly one),
      * a cols window (``cols_window_rows``, default 2M ≈ 2 GB): +/-1
        columns only, anchored dynamically as the sweep walks each rows
        window's launches in COLUMN order.

    A row chunk's band now spans multiple cols-window positions — the
    launch batcher cuts batches at window boundaries and the driver
    drains counts + finishes phase B before every move, exactly as it
    already did for the single window.  Capacity is therefore bounded by
    the packed matrix alone (128 B/hash), with the windows as fixed-size
    knobs.

    Same driver contract as ``WindowedPallasState``; requires
    R_TILES == 1 (the production geometry).
    """

    windowed = True
    split = True
    row_lo_iota = True
    rows_static = False
    uploaded_rows = None  # the streamed rows-build path does not apply

    def __init__(
        self,
        packed: np.ndarray | None,
        bounds: np.ndarray,
        n: int | None = None,
        packed_dev=None,
        rows_window_rows: int | None = None,
        cols_window_rows: int | None = None,
        geom: Geometry | None = None,
    ) -> None:
        import jax.numpy as jnp

        self.geom = geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        assert R_TILES == 1, "split sweeps assume single-row-tile chunks"
        if n is None:
            assert packed is not None
            n = packed.shape[0]
        (bounds, n_pad, n_row_chunks, first_ct, n_ct, min_bound,
         max_row_lo, align, _min_w) = _window_plan(n, bounds, geom)

        if packed_dev is not None:
            if isinstance(packed_dev, ChunkedPackedStore):
                packed_dev.extend_to(n_pad)
            assert packed_dev.shape[0] >= n_pad
        self.packed_dev = packed_dev

        bounds_np = np.full(n_pad, -1, dtype=np.int32)
        bounds_np[:n] = np.minimum(bounds, n)

        self.window_align = align
        rw, cw = _resolve_split_windows(
            n_pad, align, rows_window_rows, cols_window_rows, geom
        )
        self.rows_window_rows = rw
        self.window_rows = cw  # driver name for the COLS window
        need = -(-n_pad // align) * align + max(rw, cw)
        if packed_dev is None:
            # host-sourced library: deferred chunked h2d, overlapped
            # with the sweep of earlier windows (same scheme as
            # WindowedPallasState._ensure_packed)
            self._chunk = min(
                int(os.environ.get("VDF_STREAM_CHUNK_ROWS", "131072")),
                -(-need // 256) * 256,
            )
            total = -(-need // self._chunk) * self._chunk
            host_pad = np.zeros((total, 32), dtype=np.uint32)
            host_pad[:n] = packed
            self._host_packed: np.ndarray | None = host_pad
            self._uploaded_packed: int | None = 0
            if total * 128 > _max_alloc_bytes():
                # past the single-allocation watermark: chunked store
                self.packed_dev = ChunkedPackedStore.zeros(total)
            else:
                self.packed_dev = jnp.zeros((total, 32), jnp.uint32)
        else:
            self._host_packed = None
            self._uploaded_packed = None
            if packed_dev.shape[0] < need:
                if isinstance(packed_dev, ChunkedPackedStore):
                    packed_dev.extend_to(need)
                    self.packed_dev = packed_dev
                else:
                    pad = jnp.zeros(
                        (need - packed_dev.shape[0], 32), jnp.uint32
                    )
                    self.packed_dev = jnp.concatenate(
                        [packed_dev, pad], axis=0
                    )
        if bounds_np.size < need:
            bounds_np = np.concatenate(
                [bounds_np, np.full(need - n_pad, -1, np.int32)]
            )
        self._bounds_full = jnp.asarray(bounds_np.reshape(-1, 128))

        self.n = n
        self.n_pad = n_pad
        self.n_row_chunks = n_row_chunks
        self.first_ct = first_ct
        self.n_ct = n_ct
        self.min_bound = min_bound
        self.max_row_lo = max_row_lo
        self.max_ct = (n_pad - TILE_N) // TILE_N
        self.w0: tuple[int, int] | None = None
        self.r0: int | None = None
        self.c0: int | None = None
        self.rows_pm = None
        self.pm1 = None  # cols window
        self.bounds_dev = None
        self.row_lo_dev = None
        self.rebuilds = 0  # cols-window rebuilds
        self.rebuilds_rows = 0

    # deferred packed upload: identical contract to WindowedPallasState
    _ensure_packed = WindowedPallasState._ensure_packed

    def move_window(self, w_start: tuple[int, int]) -> None:
        """Move the rows and/or cols windows to ``(r_start, c_start)``.
        The caller must have drained every launch against the previous
        windows first (the driver's window-boundary sync)."""
        import jax.numpy as jnp

        r_start, c_start = w_start
        assert r_start % self.window_align == 0
        assert c_start % self.window_align == 0
        self._ensure_packed(
            max(r_start + self.rows_window_rows,
                c_start + self.window_rows)
        )
        chunked = isinstance(self.packed_dev, ChunkedPackedStore)
        if r_start != self.r0:
            # release before rebuilding so the allocator reuses pages
            self.rows_pm = self.bounds_dev = self.row_lo_dev = None
            if chunked:
                pk = self.packed_dev.slice_rows(
                    r_start, self.rows_window_rows
                )
                self.rows_pm, self.bounds_dev = _window_build_pk_jit(
                    self.rows_window_rows
                )(pk, self._bounds_full, jnp.int32(r_start))
                del pk
            else:
                fn = _window_build_jit(self.rows_window_rows)
                self.rows_pm, self.bounds_dev = fn(
                    self.packed_dev, self._bounds_full,
                    jnp.int32(r_start),
                )
            # iota row_lo: the operand slot aliases bounds (never read)
            self.row_lo_dev = self.bounds_dev
            self.r0 = r_start
            self.rebuilds_rows += 1
        if c_start != self.c0:
            self.pm1 = None
            if chunked:
                pk = self.packed_dev.slice_rows(
                    c_start, self.window_rows
                )
                self.pm1 = _unpack_window_jit(self.window_rows)(pk)
                del pk
            else:
                self.pm1 = _refs_cols_window_jit(self.window_rows)(
                    self.packed_dev, jnp.int32(c_start)
                )
            self.c0 = c_start
            self.rebuilds += 1
        self.w0 = (r_start, c_start)


def banded_adjacency_pallas(
    packed: np.ndarray | None,
    bounds: np.ndarray,
    tolerance_int: int,
    state: PallasSearchState | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Banded adjacency sweep via the two-phase launches.

    Same contract as ``hamming.banded_adjacency``: all pairs (i, j) with
    i < j < bounds[i] and hamming <= tolerance_int, lexicographic order.
    Pass a prebuilt ``state`` to skip the upload/unpack setup (``packed``
    may then be None — the incremental-library and windowed paths).

    Phase A sweeps the whole band with the counts-only launch (a few
    bytes of output per launch instead of the packed adjacency), so
    many launches stay in flight and count fetches amortize.  Phase B
    re-runs only the tiles that contain matches with the packing launch
    and extracts pair indices word-wise in one fused jit + one small
    fetch per hit batch.  ``sweep_launch()`` picks the launch
    implementation; on the CPU backend the launch batches are small and
    every batch is drained synchronously (the CPU test route).
    """
    import jax.numpy as jnp

    launch = sweep_launch()
    on_cpu = platform.backend() == "cpu"
    n = packed.shape[0] if state is None else state.n
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    bounds = np.asarray(bounds, dtype=np.int64)
    if state is None:
        state = PallasSearchState(packed, bounds)
    geom = state.geom
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom

    sweep_sizes = (8,) if on_cpu else tuple(
        sorted(set(SWEEP_SIZES), reverse=True)
    )
    launches = _plan_launches(state)
    rows_static = getattr(state, "rows_static", False)
    split = getattr(state, "split", False)
    if rows_static:
        # windowed refs search: rows (refs) stay resident, the cands
        # COLUMN window slides — column-major launch order makes the
        # window advance monotonically over the cands axis
        launches.sort(key=lambda b: b[1][0])
    elif split:
        # split-window self-search: group launches by their (static)
        # rows window, column-major within it, so the rows window
        # advances once per group and the cols window sweeps each
        # group's bands monotonically
        rw_sort = state.rows_window_rows
        launches.sort(
            key=lambda b: (b[0] * TILE_M // rw_sort, min(b[1]), b[0])
        )

    dbg = os.environ.get("VDF_SWEEP_DEBUG") == "1"
    ph = {"dispatch": 0.0, "stream": 0.0, "drain": 0.0, "phase_b": 0.0,
          "fetch_b": 0.0, "drains": 0, "batches": 0, "hits": 0,
          "b_batches": 0}
    is_windowed = getattr(state, "windowed", False)
    # Overlapped A/B pipeline: once pendingA exceeds 2 * drain_group,
    # the OLDEST drain_group counts drain in one concatenated d2h while
    # later phase-A batches are still executing, and the hit launches
    # found so far are re-dispatched through the packing launch
    # immediately — phase-B compute and its (batched) result fetch hide
    # behind the remaining phase-A device time instead of serializing
    # after it.
    drain_group = int(os.environ.get("VDF_COUNTS_DRAIN_GROUP", "8"))
    fetch_b_max = int(os.environ.get("VDF_FETCH_B_MAX", "64"))
    pb_sizes = (8,) if on_cpu else (PHASE_B_CALLS, 16)
    # Per-tile phase B (VDF_PHASE_B_PER_TILE, default on): phase A
    # counts per (row tile, column tile) instead of per launch stripe,
    # and phase B re-runs ONLY the hit tiles under a BAND_TILES=1
    # geometry — BAND_TILES x less repack work per hit at BAND_TILES x
    # the counts-drain volume.  Requires single-row-tile chunks;
    # auto-disabled otherwise.
    per_tile_b = (
        os.environ.get("VDF_PHASE_B_PER_TILE", "1") == "1"
        and R_TILES == 1
    )
    geom_b = geom._replace(band_tiles=1) if per_tile_b else geom

    pendingA: list[tuple[list, object]] = []  # (batch, counts handle)
    hits_cur: list[tuple[int, tuple[int, ...]]] = []  # current window
    pendingB: list[tuple[object, int, list]] = []  # (out, size, batch)
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    cur_w: int | None = None  # w_start the current window was built at

    def drain_some(k: int) -> None:
        """Decode the oldest ``k`` pending count handles (one d2h)."""
        take = pendingA[:k]
        del pendingA[:k]
        if not take:
            return
        t0 = time.perf_counter()
        ph["drains"] += 1
        flat = np.asarray(
            jnp.concatenate([c.reshape(-1) for (_, c) in take])
        )
        off = 0
        for batch, counts in take:
            size = int(np.prod(counts.shape))
            cnp = flat[off : off + size].reshape(counts.shape)
            off += size
            if per_tile_b:
                # [calls, BAND_TILES] per-tile counts: each hit TILE
                # becomes its own 1-column-tile phase-B launch
                for k2, t in zip(*np.nonzero(cnp > 0)):
                    if int(k2) < len(batch):
                        rt0, cts = batch[int(k2)]
                        hits_cur.append((rt0, (int(cts[0]) + int(t),)))
                        ph["hits"] += 1
                continue
            for k2 in np.nonzero(cnp.sum(axis=1) > 0)[0]:
                if int(k2) < len(batch):
                    hits_cur.append(batch[int(k2)])
                    ph["hits"] += 1
        ph["drain"] += time.perf_counter() - t0

    def dispatch_b(flush: bool) -> None:
        """Re-run accumulated hit launches with the packing launch.

        Launches in ``hits_cur`` were counted against the CURRENT window,
        so the packing re-run uses the same resident operands.  Without
        ``flush`` only full PHASE_B_CALLS batches go out; a flush pads the
        remainder into the smallest precompiled bucket."""
        t0 = time.perf_counter()
        while hits_cur:
            if len(hits_cur) >= pb_sizes[0]:
                size = pb_sizes[0]
            elif flush:
                size = next(
                    (s for s in sorted(pb_sizes) if s >= len(hits_cur)),
                    pb_sizes[0],
                )
            else:
                break
            batch = hits_cur[: min(size, len(hits_cur))]
            del hits_cur[: len(batch)]
            run = _build_phase_b(launch, size, geom_b)
            scalars_all = np.zeros((size, geom.n_scal), np.int32)
            _fill_scalars(
                scalars_all, batch, state, tolerance_int, n, cur_w
            )
            out = run(
                jnp.asarray(scalars_all),
                state.rows_pm if (rows_static or split) else state.pm1,
                state.pm1, state.bounds_dev, state.row_lo_dev,
            )
            pendingB.append((out, size, batch))
            ph["b_batches"] += 1
        ph["phase_b"] += time.perf_counter() - t0

    def fetch_b() -> None:
        """Fetch and decode every pending phase-B result in ONE d2h
        (not one round trip per batch).  Blocks until the dispatched
        phase-B work finishes —
        windowed states call this before moving the window so the old
        window's buffers can release."""
        take = pendingB[:]
        pendingB.clear()
        if not take:
            return
        t0 = time.perf_counter()
        flat = np.asarray(jnp.concatenate([o for (o, _, _) in take]))
        width = 2 * EXTRACT_WORD_CAP + 1
        for bi, (_, size, batch) in enumerate(take):
            arr = flat[bi * width : (bi + 1) * width]
            if not _decode_phase_b(
                arr, size, batch, out_i, out_j, geom_b
            ):
                # word capacity exceeded (rare): per-launch host fallback
                _phase_b_fallback(
                    state, batch, tolerance_int, n, launch, out_i,
                    out_j, geom_b,
                )
        ph["fetch_b"] += time.perf_counter() - t0

    pm1 = state.pm1
    rowsA = state.rows_pm if (rows_static or split) else pm1
    colsA = state.pm1
    bounds_dev = state.bounds_dev
    for batch, w_start in _gen_batches(state, launches, sweep_sizes):
        sweep_calls = next(
            (s for s in sorted(sweep_sizes) if s >= len(batch)),
            sweep_sizes[0],
        )
        counts_fn = _build_sweep_counts(
            launch, sweep_calls, geom, per_tile_b
        )
        if is_windowed:
            if w_start != state.w0:
                # finish EVERYTHING against the previous window first:
                # drain its counts, dispatch + fetch its phase B (the
                # fetch blocks until the queued launches finish), so the
                # old and new window buffers never coexist on device — and
                # phase B never has to re-slide windows in a second pass.
                drain_some(len(pendingA))
                dispatch_b(flush=True)
                fetch_b()
                pm1 = colsA = bounds_dev = None
                t0 = time.perf_counter()
                state.move_window(w_start)
                ph["stream"] += time.perf_counter() - t0
            pm1 = state.pm1
            if split:
                rowsA = state.rows_pm
            elif not rows_static:
                rowsA = pm1
            colsA = state.pm1
            bounds_dev = state.bounds_dev
            cur_w = w_start
        if state.uploaded_rows is not None:
            # streamed build: h2d overlaps the counts sweep
            need = 0
            for rt0, cts in batch:
                need = max(
                    need,
                    (rt0 + R_TILES) * TILE_M,
                    (max(cts) + BAND_TILES) * TILE_N,
                )
            t0 = time.perf_counter()
            state.ensure_rows(need)
            ph["stream"] += time.perf_counter() - t0
            pm1 = rowsA = colsA = state.pm1
        scalars_all = np.zeros((sweep_calls, geom.n_scal), np.int32)
        _fill_scalars(scalars_all, batch, state, tolerance_int, n, w_start)
        t0 = time.perf_counter()
        counts = counts_fn(
            jnp.asarray(scalars_all), rowsA, colsA, bounds_dev,
            state.row_lo_dev,
        )
        ph["dispatch"] += time.perf_counter() - t0
        ph["batches"] += 1
        pendingA.append((batch, counts))
        if on_cpu:
            # CPU test route: fully synchronous per batch
            drain_some(len(pendingA))
            dispatch_b(flush=True)
            fetch_b()
        elif len(pendingA) >= 2 * drain_group:
            drain_some(drain_group)
            dispatch_b(flush=False)
            # windowed states only fetch at window boundaries: a mid-
            # stream fetch could take the _phase_b_fallback path, whose
            # exact recompute re-slides the window under the launches
            # still being dispatched against the current one
            if not is_windowed and len(pendingB) >= fetch_b_max:
                fetch_b()
    drain_some(len(pendingA))
    dispatch_b(flush=True)
    fetch_b()

    if dbg:
        print(
            "# sweep phases: "
            + " ".join(
                f"{k}={v:.3f}s" if isinstance(v, float) else f"{k}={v}"
                for k, v in ph.items()
            ),
            file=sys.stderr,
        )
    global LAST_SWEEP_PHASES
    LAST_SWEEP_PHASES = dict(ph)

    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]


def _phase_b_fallback(
    state,
    batch: list[tuple[int, tuple[int, ...]]],
    tolerance_int: int,
    n: int,
    launch: str,
    out_i: list[np.ndarray],
    out_j: list[np.ndarray],
    geom_b: "Geometry | None" = None,
) -> None:
    """Word-capacity overflow path: re-run each launch singly with the
    packing launch, fetch its packed tiles wholesale, and bit-extract on
    host.  Only reached when one phase-B batch holds more than
    EXTRACT_WORD_CAP matching words.  ``geom_b``: the phase-B geometry
    (BAND_TILES=1 under the per-tile knob)."""
    import jax.numpy as jnp

    geom = geom_b if geom_b is not None else state.geom
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    fn = _build_chunk(launch, geom)
    is_windowed = getattr(state, "windowed", False)
    rows_static = getattr(state, "rows_static", False)
    split = getattr(state, "split", False)
    for rt0, cts in batch:
        w_start = None
        if is_windowed:
            align = state.window_align
            total = int(state.packed_dev.shape[0])
            wmax = total - state.window_rows
            if split:
                rw = state.rows_window_rows
                w_start = (
                    min(rt0 * TILE_M // rw * rw, total - rw),
                    min(min(cts) * TILE_N // align * align, wmax),
                )
            else:
                anchor = (
                    min(cts) * TILE_N if rows_static else rt0 * TILE_M
                )
                w_start = min((anchor // align) * align, wmax)
            if w_start != state.w0:
                state.move_window(w_start)
        scal = np.zeros((1, geom.n_scal), np.int32)
        _fill_scalars(scal, [(rt0, cts)], state, tolerance_int, n, w_start)
        packed_t, _ = fn(
            jnp.asarray(scal[0]),
            state.rows_pm if (rows_static or split) else state.pm1,
            state.pm1, state.bounds_dev, state.row_lo_dev,
        )
        tiles = np.asarray(packed_t)
        for i in range(R_TILES):
            for j in range(BAND_TILES):
                roff, coff = _tile_bits_to_pairs(tiles[i, j])
                out_i.append(roff.astype(np.int64) + (rt0 + i) * TILE_M)
                out_j.append(coff.astype(np.int64) + (cts[i] + j) * TILE_N)



def refs_adjacency_pallas(
    refs_packed: np.ndarray,
    cands_packed: np.ndarray | None,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    cands_dev=None,
    n_cands: int | None = None,
    geom: Geometry | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """References-vs-candidates adjacency on the Pallas sweep kernel.

    All pairs (i, j) with lo[i] <= j < hi[i] and hamming <= tolerance,
    lexicographic — the device path for ``search_with_references``
    (video_dup_finder.rs:19-46's [0.95d, 1.05d] window).  The refs rows
    are appended AFTER the candidate block in one device matrix, and the
    kernel's generalized per-row [row_lo + 1, bounds) window does the
    rest: row_lo = lo - 1, bounds = hi (the self-search is the special
    case row_lo = own index).

    ``cands_dev`` (+ ``n_cands``): a DEVICE-RESIDENT duration-sorted
    packed candidate matrix (uint32[>= n_cands, 32], e.g. gathered from
    an ``IncrementalDeviceLibrary``) replaces the host ``cands_packed``
    — the combined [cands | refs] matrix is assembled on device and only
    the refs (128 B each) ride h2d, eliminating the library re-upload
    that would make cold multi-reference searches upload-bound.
    """
    import jax.numpy as jnp

    geom = geom if geom is not None else Geometry()
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    r = refs_packed.shape[0]
    n = int(n_cands) if cands_dev is not None else cands_packed.shape[0]
    if r == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)

    # combined layout: [cands (tile-padded) | refs (tile-padded)]
    n_col_pad = -(-n // TILE_N) * TILE_N + (BAND_TILES + 1) * TILE_N
    ref0 = n_col_pad  # first refs row (row-tile aligned: TILE_N % TILE_M == 0)
    n_ref_tiles = -(-r // TILE_M)
    n_ref_chunks = -(-n_ref_tiles // R_TILES)
    n_pad = ref0 + n_ref_chunks * R_TILES * TILE_M

    bounds_full = np.full(n_pad, -1, dtype=np.int64)
    bounds_full[ref0 : ref0 + r] = np.minimum(hi, n)
    row_lo_full = np.full(n_pad, _ROW_LO_SENTINEL, dtype=np.int64)
    row_lo_full[ref0 : ref0 + r] = lo - 1

    if cands_dev is not None:
        refs_pad = np.zeros(
            (n_pad - ref0, refs_packed.shape[1]), np.uint32
        )
        refs_pad[:r] = refs_packed
        combined = _refs_combine_jit()(
            cands_dev[:n],
            jnp.asarray(refs_pad),
            n_pad,
        )
        state = _RefsState(
            None, bounds_full, row_lo_full, n, ref0, r,
            combined_dev=combined, geom=geom,
        )
    else:
        packed_pad = np.zeros((n_pad, cands_packed.shape[1]), np.uint32)
        packed_pad[:n] = cands_packed
        packed_pad[ref0 : ref0 + r] = refs_packed
        state = _RefsState(
            packed_pad, bounds_full, row_lo_full, n, ref0, r, geom=geom
        )
    ii, jj = banded_adjacency_pallas(
        None, bounds_full, tolerance_int, state=state
    )
    return ii - ref0, jj


@functools.cache
def _refs_meta_jit():
    """Device build of the combined matrix's bounds/row_lo columns from
    the refs-region rows alone (candidate rows are all sentinels)."""
    import functools as _ft

    import jax
    import jax.numpy as jnp

    @_ft.partial(jax.jit, static_argnums=(2, 3))
    def f(bounds_rows, row_lo_rows, n_pad, ref0):
        b = jnp.full((n_pad, 1), -1, jnp.int32)
        b = jax.lax.dynamic_update_slice(b, bounds_rows[:, None], (ref0, 0))
        r = jnp.full((n_pad, 1), _ROW_LO_SENTINEL, jnp.int32)
        r = jax.lax.dynamic_update_slice(r, row_lo_rows[:, None], (ref0, 0))
        return b, r

    return f


@functools.cache
def _refs_combine_jit():
    """Device assembly of the [cands | refs] combined packed matrix: the
    candidate block stays resident, only the (small) refs block rides
    h2d."""
    import functools as _ft

    import jax
    import jax.numpy as jnp

    @_ft.partial(jax.jit, static_argnums=(2,))
    def f(cands_dev, refs_rows, n_pad):
        buf = jnp.zeros((n_pad, 32), jnp.uint32)
        buf = jax.lax.dynamic_update_slice(buf, cands_dev, (0, 0))
        buf = jax.lax.dynamic_update_slice(
            buf, refs_rows, (n_pad - refs_rows.shape[0], 0)
        )
        return buf

    return f


class _RefsState(PallasSearchState):
    """PallasSearchState over the combined [cands | refs] matrix, with
    launch metadata covering only the refs row tiles."""

    row_lo_iota = False  # per-ref [0.95d, 1.05d] lower bounds are data

    def __init__(self, packed_pad, bounds_full, row_lo_full, n_cands,
                 ref0, r, combined_dev=None,
                 geom: Geometry | None = None) -> None:
        import jax.numpy as jnp

        self.geom = geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        # the floor-divisions below silently DROP trailing refs tiles if
        # the refs region start isn't chunk-aligned; the default geometry
        # guarantees it, non-default knobs must too
        assert R_TILES == 1, "refs search assumes single-row-tile chunks"
        assert ref0 % TILE_M == 0 and TILE_N % TILE_M == 0, (
            "refs region must start row-tile aligned (TILE_N % TILE_M)"
        )
        n_pad = (
            combined_dev.shape[0] if packed_pad is None
            else packed_pad.shape[0]
        )
        assert n_pad % TILE_M == 0
        self.uploaded_rows = None
        if packed_pad is None:
            # resident-library path: combined matrix assembled on device
            self.pm1 = unpack_pm1_device(combined_dev)
        else:
            self.pm1 = unpack_pm1_device(jnp.asarray(packed_pad))
        self.pm1.block_until_ready()

        if packed_pad is None:
            # metadata built on device from the (small) refs region only
            # (no full [n_pad, 1] h2d per search)
            self.bounds_dev, self.row_lo_dev = _refs_meta_jit()(
                jnp.asarray(bounds_full[ref0:].astype(np.int32)),
                jnp.asarray(row_lo_full[ref0:].astype(np.int32)),
                n_pad,
                ref0,
            )
        else:
            self.bounds_dev = jnp.asarray(
                bounds_full.astype(np.int32)[:, None]
            )
            self.row_lo_dev = jnp.asarray(
                row_lo_full.astype(np.int32)[:, None]
            )

        n_tiles = n_pad // TILE_M
        first_ct = np.zeros(n_tiles, dtype=np.int64)
        n_ct = np.zeros(n_tiles, dtype=np.int64)
        min_bound = np.zeros(n_tiles, dtype=np.int64)
        max_row_lo = np.full(n_tiles, _ROW_LO_SENTINEL, dtype=np.int64)
        ref_t0 = ref0 // TILE_M
        for rt in range(ref_t0, n_tiles):
            r0 = rt * TILE_M
            r1 = min(r0 + TILE_M, ref0 + r)
            if r0 >= ref0 + r:
                continue
            ct0 = int(row_lo_full[r0:r1].min() + 1) // TILE_N
            c_end = int(bounds_full[r0:r1].max())
            first_ct[rt] = ct0
            n_ct[rt] = max(0, -(-(c_end - ct0 * TILE_N) // TILE_N))
            min_bound[rt] = int(bounds_full[r0:r1].min())
            if r1 == r0 + TILE_M:
                max_row_lo[rt] = int(row_lo_full[r0:r1].max())
        # the driver iterates row chunks [0, n_row_chunks); start at the
        # refs region by reporting only those chunks and offsetting in
        # first_ct/n_ct indexing (chunk_idx * R_TILES is an absolute row
        # tile index, so metadata arrays stay absolute-indexed)
        self.n = n_cands  # kernel's col clamp only
        self.n_pad = n_pad
        self.n_row_chunks = n_tiles // R_TILES
        self.first_ct = first_ct
        self.n_ct = n_ct
        self.min_bound = min_bound
        self.max_row_lo = max_row_lo
        self.max_ct = (n_pad - TILE_N) // TILE_N


@functools.cache
def _refs_cols_window_jit(w_rows: int):
    """uint32[*, 32] packed cands -> one +/-1 COLUMN window
    [w_rows, 1024] starting at row ``at`` (chunked under lax.scan like
    ``_window_build_jit``; no bounds slice — refs-row metadata is static
    and lives in refs space, not cands space)."""
    import math

    import jax

    @jax.jit
    def f(packed_dev, at):
        pk = jax.lax.dynamic_slice(packed_dev, (at, 0), (w_rows, 32))
        return unpack_pm_scan(pk, math.gcd(w_rows, 1024))

    return f


class WindowedRefsState:
    """Windowed references-vs-candidates search state: the refs ROWS (+ their per-row
    [0.95d, 1.05d) metadata, ``video_dup_finder.rs:19-46``) stay fully
    resident — they are tiny — while the CANDIDATE axis follows the
    ``WindowedPallasState`` recipe: the packed library (128 B/hash) is
    fully device-resident and the 1 KB/hash +/-1 expansion exists only
    for a sliding COLUMN window, so large candidate libraries never
    materialize a 1 KB/hash operand.

    Shape bucketing: the refs row pad rounds
    up to a power-of-two number of row tiles and the column window is a
    power-of-two number of column tiles (capped by VDF_REFS_WINDOW_ROWS),
    so the expensive sweep jits — whose signatures see only
    [r_pad, 1024] rows, [window_rows, 1024] cols and the launch-scalar
    batch — repeat across nearby (r, n) shapes and hit the persistent
    compile cache instead of paying a first-call specialization per
    novel pair.

    Plugs into ``banded_adjacency_pallas``'s windowed driver via
    ``rows_static = True``: row-tile indices stay absolute (refs space),
    only column tiles are window-relative, and the driver orders
    launches column-major so the window slides monotonically.
    """

    windowed = True
    row_lo_iota = False  # per-ref lower bounds are data
    rows_static = True
    uploaded_rows = None  # the streamed rows-build path does not apply

    def __init__(
        self,
        refs_packed: np.ndarray,
        lo: np.ndarray,
        hi: np.ndarray,
        n_cands: int,
        cands_packed: np.ndarray | None = None,
        cands_dev=None,
        window_rows: int | None = None,
        geom: Geometry | None = None,
    ) -> None:
        import jax.numpy as jnp

        self.geom = geom = geom if geom is not None else Geometry()
        TILE_M, TILE_N, R_TILES, BAND_TILES = geom
        assert R_TILES == 1, "refs search assumes single-row-tile chunks"
        r = refs_packed.shape[0]
        n = int(n_cands)
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)

        # refs rows: power-of-two row-tile bucket
        r_tiles = max(1, -(-r // TILE_M))
        r_tiles = 1 << (r_tiles - 1).bit_length()
        r_pad = r_tiles * TILE_M
        refs_pad = np.zeros((r_pad, 32), np.uint32)
        refs_pad[:r] = refs_packed
        self.rows_pm = unpack_pm1_device(jnp.asarray(refs_pad))
        bounds_np = np.full((r_pad, 1), -1, dtype=np.int32)
        bounds_np[:r, 0] = np.minimum(hi, n)
        row_lo_np = np.full((r_pad, 1), _ROW_LO_SENTINEL, dtype=np.int32)
        row_lo_np[:r, 0] = np.maximum(lo, 0) - 1
        self.bounds_dev = jnp.asarray(bounds_np)
        self.row_lo_dev = jnp.asarray(row_lo_np)

        # per-refs-tile launch metadata over the cands axis; partial
        # tiles keep the sentinel max_row_lo
        first_ct = np.zeros(r_tiles, dtype=np.int64)
        n_ct = np.zeros(r_tiles, dtype=np.int64)
        min_bound = np.zeros(r_tiles, dtype=np.int64)
        max_row_lo = np.full(r_tiles, _ROW_LO_SENTINEL, dtype=np.int64)
        for rt in range(r_tiles):
            r0 = rt * TILE_M
            r1 = min(r0 + TILE_M, r)
            if r0 >= r:
                continue
            ct0 = int(max(int(lo[r0:r1].min()), 0)) // TILE_N
            c_end = int(min(int(hi[r0:r1].max()), n))
            first_ct[rt] = ct0
            n_ct[rt] = max(0, -(-(c_end - ct0 * TILE_N) // TILE_N))
            min_bound[rt] = int(min(int(hi[r0:r1].min()), n))
            if r1 == r0 + TILE_M:
                max_row_lo[rt] = int(lo[r0:r1].max()) - 1

        # candidate axis: packed resident, +/-1 only per column window
        n_cpad = (
            -(-max(n, 1) // TILE_N) * TILE_N + (BAND_TILES + 1) * TILE_N
        )
        self.window_align = align = TILE_N
        assert align % 128 == 0
        cap_rows = (
            int(window_rows)
            if window_rows
            else int(os.environ.get("VDF_REFS_WINDOW_ROWS", str(1 << 21)))
        )
        cap_tiles = max(-(-cap_rows // TILE_N), BAND_TILES + 1)
        need_tiles = -(-n_cpad // TILE_N)
        w_tiles = 1 << (min(need_tiles, cap_tiles) - 1).bit_length()
        self.window_rows = w_rows = w_tiles * TILE_N
        need = -(-n_cpad // align) * align + w_rows

        if isinstance(cands_dev, ChunkedPackedStore):
            # chunked store (candidates past the single-allocation
            # watermark): rows beyond the library's n are zeros by
            # construction and masked by the kernel's n clamp; shallow-
            # copy the chunk list so the slide-room extension never
            # mutates the library's own store
            store = ChunkedPackedStore(
                list(cands_dev.chunks), cands_dev.chunk_rows
            )
            store.extend_to(need)
            self.packed_dev = store
            self._host_packed: np.ndarray | None = None
            self._uploaded_packed: int | None = None
        elif cands_dev is not None:
            # device-born candidates: zero-pad on device, no h2d
            pad = jnp.zeros((need - n, 32), jnp.uint32)
            self.packed_dev = jnp.concatenate([cands_dev[:n], pad])
            self._host_packed = None
            self._uploaded_packed = None
        else:
            # host-sourced: deferred chunked h2d, overlapped with the
            # sweep of earlier windows (same scheme as
            # WindowedPallasState._ensure_packed)
            self._chunk = min(
                int(os.environ.get("VDF_STREAM_CHUNK_ROWS", "131072")),
                -(-need // 256) * 256,
            )
            total = -(-need // self._chunk) * self._chunk
            host_pad = np.zeros((total, 32), dtype=np.uint32)
            host_pad[:n] = cands_packed[:n]
            self._host_packed = host_pad
            self._uploaded_packed = 0
            if total * 128 > _max_alloc_bytes():
                self.packed_dev = ChunkedPackedStore.zeros(total)
            else:
                self.packed_dev = jnp.zeros((total, 32), jnp.uint32)

        self.n = n
        self.n_pad = n_cpad
        self.n_row_chunks = r_tiles
        self.first_ct = first_ct
        self.n_ct = n_ct
        self.min_bound = min_bound
        self.max_row_lo = max_row_lo
        self.max_ct = (n_cpad - TILE_N) // TILE_N
        self.w0: int | None = None
        self.pm1 = None
        self.rebuilds = 0

    # deferred packed upload: identical contract to WindowedPallasState
    _ensure_packed = WindowedPallasState._ensure_packed

    def move_window(self, w_start: int) -> None:
        """Slide the resident +/-1 COLUMN window to start at candidate
        row ``w_start`` (refs rows/metadata never move)."""
        import jax.numpy as jnp

        assert w_start % self.window_align == 0
        self._ensure_packed(w_start + self.window_rows)
        self.pm1 = None  # release before rebuilding
        if isinstance(self.packed_dev, ChunkedPackedStore):
            pk = self.packed_dev.slice_rows(w_start, self.window_rows)
            self.pm1 = _unpack_window_jit(self.window_rows)(pk)
            del pk
        else:
            self.pm1 = _refs_cols_window_jit(self.window_rows)(
                self.packed_dev, jnp.int32(w_start)
            )
        self.w0 = w_start
        self.rebuilds += 1


def refs_adjacency_windowed(
    refs_packed: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    cands_packed: np.ndarray | None = None,
    cands_dev=None,
    n_cands: int | None = None,
    window_rows: int | None = None,
    geom: Geometry | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """References-vs-candidates adjacency with a sliding candidate
    window: all pairs (i, j), i a refs row, lo[i] <= j < hi[i], hamming
    <= tolerance_int, in lexicographic order — output-identical to
    ``refs_adjacency_pallas`` but scaling to candidate libraries beyond
    +/-1 HBM capacity (and with bucketed jit shapes; see
    ``WindowedRefsState``).  ``cands_dev`` + ``n_cands``: device-resident
    packed candidates (refs-only h2d); else ``cands_packed`` rides a
    deferred chunked upload."""
    r = refs_packed.shape[0]
    n = int(n_cands) if cands_dev is not None else cands_packed.shape[0]
    if r == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    state = WindowedRefsState(
        refs_packed, lo, hi, n,
        cands_packed=cands_packed, cands_dev=cands_dev,
        window_rows=window_rows, geom=geom,
    )
    return banded_adjacency_pallas(
        None, np.zeros(0, np.int64), tolerance_int, state=state,
    )
