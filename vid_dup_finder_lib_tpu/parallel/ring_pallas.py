"""Multi-device banded search: the two-phase int8 sweep over a ppermute ring.

This is the production multi-device backend behind
``search(backend="ring")``.  Layout and algorithm (SURVEY.md section 2.7's
blueprint; semantics preserved: ``search_algorithm.rs:81-171``):

* The duration-sorted PACKED library (128 B/hash) is sharded over a 1D
  ``jax.sharding.Mesh``: shard ``d`` owns the contiguous row block
  ``[d * Ns, (d + 1) * Ns)``.
* A copy of the packed matrix rotates BACKWARD around the ring with
  ``jax.lax.ppermute`` — after ``s`` rotations shard ``d`` holds the
  packed rows of block ``d + s``.  Only packed bytes ride the
  interconnect (8x less traffic than rotating the +/-1 int8 expansion).
* Because hashes are duration-sorted, each row's candidate window
  ``[i + 1, bounds[i])`` is a near-diagonal band: the host planner emits
  launches ONLY for (shard, step) pairs whose column block intersects the
  band, so the ring stops after ``k_max + 1`` steps (the band's block
  span), NOT ``n_devices`` steps — per-device work is O(n * band /
  n_devices) and the full O(N^2) rectangle is never touched.
* Each shard runs the exact same two-phase banded sweep as the
  single-device path — ``ops/hamming_pallas``'s counts-only launch over
  every launch, then the packing launch + fused word extraction over the
  rare launches that contain matches — via ``shard_map``: per-shard
  launch scalars ride a sharded scalar array, so one SPMD program serves
  every shard (padded launches carry tol = -1 and match nothing).
* Window composition (large libraries x several devices): the +/-1 operands
  are materialized per ROW WINDOW of each shard (``window_rows``), with
  the column operand a matching window of the parked block — per-shard
  live memory is O(window + band) +/-1 bytes plus the packed shard
  (Ns / 8 KB), never O(Ns) * 1 KB.  The default window is the whole
  shard (one window) when it fits.

Pad-column guard: the parked block is zero-padded so a launch's
BAND_TILES stripe may overhang the block's end; overhang columns get
masked because each launch's ``n`` scalar is clamped to the block end
(a zero-packed pad column unpacks to the all-(-1) vector, which a real
all-zero hash WOULD match at distance 0 — the clamp makes that
impossible rather than unlikely).

Exactness: pairs come out in global lexicographic order, so the host
greedy replay produces groups identical to every single-device backend.
"""

from __future__ import annotations

import functools
import math
import os
import time

import numpy as np

from .. import platform
from ..ops import hamming_pallas as hp

# sized-nonzero capacity of one phase-B batch PER SHARD (matching words;
# overflow falls back to an exact host recompute of that batch)
RING_EXTRACT_CAP = int(os.environ.get("VDF_RING_EXTRACT_CAP", "8192"))
RING_HOT_ROWS = int(os.environ.get("VDF_RING_HOT_ROWS", "1024"))

# phase breakdown of the most recent banded_adjacency_ring call
# (seconds + counters) — bench_scale.py records it with ring points
LAST_RING_PHASES: dict = {}


def _align(geom: "hp.Geometry | None" = None) -> int:
    geom = geom if geom is not None else hp.Geometry()
    return int(np.lcm(geom.tile_m * geom.r_tiles, geom.tile_n))


@functools.cache
def _ring_jits(
    axis: str,
    mesh,
    launch: str,
    sweep_calls: int,
    pb_calls: int,
    w_rows: int,
    cw_rows: int,
    ns: int,
    geom: "hp.Geometry" = None,
):
    """Compiled SPMD ring primitives for one geometry.

    Returns (operands_fn, counts_fn, phase_b_fn, rotate_fn, shard_fn,
    operands0_fn):
    * operands_fn(own_pk, col_pk, bounds_c, row_lo_c, s_w, c_off)
      -> (rows_pm, cols_pm, bounds, row_lo): one (step, window)'s
      windowed +/-1 operands, built once and shared by every batch
    * operands0_fn(same args) -> (cols_pm, bounds, row_lo): the step-0
      variant where rows are a prefix of the column window (one unpack)
    * counts_fn(rows_pm, cols_pm, bounds, row_lo, scalars)
      -> int32[n_dev * sweep_calls, R_TILES] per-launch match counts
    * phase_b_fn(same operands, scalars)
      -> int32[n_dev, 2 * CAP + 1] per-shard [word locs | words | total]
    * rotate_fn(col_pk) -> col_pk rotated one step backward on the ring
    * shard_fn(arr) -> the sharded device copy
    """
    from ..utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    geom = geom if geom is not None else hp.Geometry()
    n_scal = geom.n_scal
    counts_chunk = hp._build_chunk_counts(launch, geom)
    pack_chunk = hp._build_chunk(launch, geom)

    def unpack_rows(pk):
        """uint32[K, 32] -> PM_DTYPE[K, 1024] over {-1, +1} (shared
        chunked-scan body: ops/hamming_pallas.unpack_pm_scan)."""
        return hp.unpack_pm_scan(pk, math.gcd(pk.shape[0], 4096))

    def _row_meta(bounds_c, row_lo_c, s_w):
        b = jax.lax.dynamic_slice(
            bounds_c, (s_w // 128, 0), (w_rows // 128, 128)
        ).reshape(w_rows, 1)
        r = jax.lax.dynamic_slice(
            row_lo_c, (s_w // 128, 0), (w_rows // 128, 128)
        ).reshape(w_rows, 1)
        return b, r

    def _cols_pm(col_pk, c_off):
        col_src = jnp.concatenate(
            [col_pk, jnp.zeros((cw_rows, 32), jnp.uint32)]
        )
        cols_pk = jax.lax.dynamic_slice(col_src, (c_off, 0), (cw_rows, 32))
        return unpack_rows(cols_pk)

    def operands(own_pk, col_pk, bounds_c, row_lo_c, s_w, c_off):
        """Window the per-shard operands: rows [s_w, s_w + w_rows) of the
        own block, cols [c_off, c_off + cw_rows) of the parked block
        (zero-padded past its end), and the row metadata reshaped from
        its lane-compact [ns // 128, 128] storage."""
        rows_pk = jax.lax.dynamic_slice(own_pk, (s_w, 0), (w_rows, 32))
        rows_pm = unpack_rows(rows_pk)
        cols_pm = _cols_pm(col_pk, c_off)
        b, r = _row_meta(bounds_c, row_lo_c, s_w)
        return rows_pm, cols_pm, b, r

    def operands_step0(own_pk, col_pk, bounds_c, row_lo_c, s_w, c_off):
        """Step-0 operands: the parked block IS the own block and
        c_off == s_w, so the row window is a PREFIX of the column window
        — build only the column +/-1 expansion and let the kernel read
        its row tiles out of the same array (halves the per-window
        unpack cost, the dominant term of the degenerate 1-device ring)."""
        cols_pm = _cols_pm(col_pk, c_off)
        b, r = _row_meta(bounds_c, row_lo_c, s_w)
        return cols_pm, b, r

    def counts_body(rows_pm, cols_pm, b, r, scalars):
        scal = scalars.reshape(sweep_calls, n_scal)

        def body(_, sc):
            return None, counts_chunk(sc, rows_pm, cols_pm, b, r)

        _, counts = jax.lax.scan(body, None, scal)
        return counts  # [sweep_calls, R_TILES]

    def phase_b_body(rows_pm, cols_pm, b, r, scalars):
        scal = scalars.reshape(pb_calls, n_scal)

        def body(_, sc):
            packed_t, _ = pack_chunk(sc, rows_pm, cols_pm, b, r)
            return None, packed_t

        _, packed_all = jax.lax.scan(body, None, scal)
        flat = packed_all.reshape(-1)
        # two-level extraction (the single-device PHASE_B_V2 design,
        # hamming_pallas._build_phase_b): jnp.nonzero lowers to a full
        # sort over a 64-launch batch's ~33M packed words.  Reduce words
        # to 1024-word-row
        # counts, sized-nonzero the tiny row list, gather the hot rows,
        # and word-extract only those — with hot-row overflow inflating
        # ``total`` past the cap so the decoder takes the exact host
        # fallback.
        pad = (-flat.size) % 1024  # static; small test geometries
        if pad:
            flat = jnp.concatenate(
                [flat, jnp.zeros((pad,), flat.dtype)]
            )
        rows = flat.reshape(-1, 1024)
        rownz = jnp.sum((rows != 0).astype(jnp.int32), axis=1)
        hot = jnp.nonzero(
            rownz > 0, size=RING_HOT_ROWS, fill_value=-1
        )[0].astype(jnp.int32)
        hot_total = jnp.sum((rownz > 0).astype(jnp.int32))
        sub = jnp.take(rows, jnp.maximum(hot, 0), axis=0)
        sub = jnp.where((hot >= 0)[:, None], sub, 0)
        sub_flat = sub.reshape(-1)
        nz = sub_flat != 0
        total = jnp.sum(nz.astype(jnp.int32))
        loc2 = jnp.nonzero(
            nz, size=RING_EXTRACT_CAP, fill_value=-1
        )[0].astype(jnp.int32)
        val = jnp.take(sub_flat, jnp.maximum(loc2, 0))
        loc = jnp.where(
            loc2 >= 0,
            jnp.take(hot, jnp.maximum(loc2, 0) // 1024) * 1024
            + loc2 % 1024,
            -1,
        ).astype(jnp.int32)
        overflow = (hot_total > RING_HOT_ROWS).astype(jnp.int32)
        total = total + overflow * (RING_EXTRACT_CAP + 1)
        return jnp.concatenate([loc, val, total[None]])[None, :]

    def rotate_body(col_pk):
        n_dev = jax.lax.psum(1, axis)
        # backward ring: shard d receives block (d + 1) — after s steps
        # shard d holds the packed rows of block d + s (columns AHEAD of
        # its rows, the only direction the sorted band reaches)
        perm = [(t, (t - 1) % n_dev) for t in range(n_dev)]
        return jax.lax.ppermute(col_pk, axis, perm)

    blk = P(axis, None)
    # operands materialize ONCE per (step, window) — the windowed +/-1
    # unpack is the expensive part, and hoisting it out of the batch
    # calls lets any number of launch batches share it (and phase B
    # reuses phase A's operands when memory allows; see the driver)
    operands_fn = jax.jit(
        shard_map(
            operands,
            mesh=mesh,
            in_specs=(blk, blk, blk, blk, P(), P()),
            out_specs=(blk, blk, blk, blk),
            check_vma=False,
        )
    )
    operands0_fn = jax.jit(
        shard_map(
            operands_step0,
            mesh=mesh,
            in_specs=(blk, blk, blk, blk, P(), P()),
            out_specs=(blk, blk, blk),
            check_vma=False,
        )
    )
    counts_fn = jax.jit(
        shard_map(
            counts_body,
            mesh=mesh,
            in_specs=(blk, blk, blk, blk, P(axis, None, None)),
            out_specs=blk,
            check_vma=False,
        )
    )
    phase_b_fn = jax.jit(
        shard_map(
            phase_b_body,
            mesh=mesh,
            in_specs=(blk, blk, blk, blk, P(axis, None, None)),
            out_specs=blk,
            check_vma=False,
        )
    )
    rotate_fn = jax.jit(
        shard_map(
            rotate_body,
            mesh=mesh,
            in_specs=(blk,),
            out_specs=blk,
            check_vma=False,
        )
    )

    def shard_fn(arr_np):
        return jax.device_put(arr_np, NamedSharding(mesh, blk))

    return (
        operands_fn, counts_fn, phase_b_fn, rotate_fn, shard_fn,
        operands0_fn,
    )


def ring_capacity_ok(
    n: int,
    bounds: np.ndarray,
    n_dev: int,
    geom: "hp.Geometry | None" = None,
) -> bool:
    """Does the ring's per-shard footprint fit the device budget?

    The ring's COLUMN +/-1 window must span the widest duration band
    (``cw_rows = w_rows + max_span``, ``banded_adjacency_ring``) — the
    same band-span bound the single-device ``SplitWindowState`` exists to
    break.  Until the ring grows a split-column analogue, a shard whose
    minimum footprint (two packed blocks at 128 B/row + the smallest
    legal rows window + its band-spanning column window at 1 KB/row)
    exceeds ``hamming_pallas.hbm_budget_bytes`` must NOT take the ring:
    ``backend="auto"`` falls back to the single-device split path on one
    device of the mesh.
    """
    ns, _, w_rows, cw_rows = _ring_window_plan(n, bounds, n_dev, geom)
    pm_bytes = 1024 if hp.PM_DTYPE == "int8" else 2048
    footprint = 2 * ns * 128 + (w_rows + cw_rows) * pm_bytes
    return footprint <= hp.hbm_budget_bytes()


def _ring_window_plan(
    n: int,
    bounds: np.ndarray,
    n_dev: int,
    geom: "hp.Geometry | None" = None,
    window_rows: int | None = None,
):
    """Shared shard/window sizing of the ring sweep.

    Returns ``(ns, bounds_c, w_rows, cw_rows)``: aligned rows per
    shard, clipped bounds, the sliding rows window, and its
    band-spanning column window.  ``banded_adjacency_ring`` runs this
    exact plan and ``ring_capacity_ok`` vetoes on it, so the capacity
    rule can never desynchronize from the geometry the sweep actually
    launches (one rule, one place).
    """
    geom = geom if geom is not None else hp.Geometry()
    align = _align(geom)
    ns = -(-(-(-n // n_dev)) // align) * align
    bounds_c = np.minimum(np.asarray(bounds, dtype=np.int64), n)
    if window_rows is None:
        env = os.environ.get("VDF_RING_WINDOW_ROWS")
        if env:
            window_rows = int(env)
        else:
            # same budget derivation as the single-device resident
            # rule: per-shard +/-1 operands are ~(w_rows + cw_rows) KB
            # ~= 2 * w_rows KB
            threshold = platform.resident_rows()
            window_rows = min(ns, max(align, threshold // 2))
    w_rows = min(max(-(-int(window_rows) // align) * align, align), ns)
    # column-window span: rows' own window + widest band + stripe pad
    spans = bounds_c - np.arange(n)
    max_span = int(spans.max()) if n else 0
    pad_rows = (geom.band_tiles + 1) * geom.tile_n
    cw_rows = (
        min(w_rows + -(-max(max_span, 1) // align) * align, ns) + pad_rows
    )
    return ns, bounds_c, w_rows, cw_rows


def _plan_ring_launches(
    n: int,
    n_dev: int,
    ns: int,
    bounds_c: np.ndarray,
    w_rows: int,
    n_win: int,
    geom: "hp.Geometry | None" = None,
):
    """Host launch planner.

    Returns (launches, k_max): ``launches[(s, w, d)]`` is the list of
    (global row tile, global first col tile) stripes shard ``d`` runs at
    ring step ``s`` within row window ``w``.  Only (step, block)
    intersections of the duration band are emitted — the block-level
    band skipping that keeps per-device work O(band / n_devices).
    """
    geom = geom if geom is not None else hp.Geometry()
    tile_m, tile_n, band = geom.tile_m, geom.tile_n, geom.band_tiles
    launches: dict[tuple[int, int, int], list[tuple[int, int]]] = {}
    k_max = 0
    for d in range(n_dev):
        base = d * ns
        if base >= n:
            break
        for rt_local in range(ns // tile_m):
            r0 = base + rt_local * tile_m
            if r0 >= n:
                break
            r1 = min(r0 + tile_m, n)
            w = min((rt_local * tile_m) // w_rows, n_win - 1)
            c_lo = r0 + 1
            c_hi = int(bounds_c[r0:r1].max())
            if c_hi <= c_lo:
                continue
            ct_start = c_lo // tile_n
            ct_end = -(-c_hi // tile_n)
            g_rt = r0 // tile_m
            for s in range(n_dev - d):
                blk_ct0 = (d + s) * ns // tile_n
                blk_ct1 = ((d + s + 1) * ns) // tile_n
                a = max(ct_start, blk_ct0)
                b = min(ct_end, blk_ct1)
                if a >= b:
                    if blk_ct0 >= ct_end:
                        break
                    continue
                k_max = max(k_max, s)
                lst = launches.setdefault((s, w, d), [])
                lst.extend((g_rt, ct0) for ct0 in range(a, b, band))
    return launches, k_max


def _fill_ring_scalars(
    scal: np.ndarray,
    batch: list[tuple[int, int]],
    d: int,
    s: int,
    ns: int,
    n: int,
    s_w: int,
    c_off: int,
    tolerance_int: int,
    min_bound: np.ndarray,
    max_row_lo: np.ndarray,
    w_rows: int,
    cw_rows: int,
    geom: "hp.Geometry | None" = None,
) -> None:
    """Per-shard launch scalars (layout: ops/hamming_pallas._build_chunk).
    Row/col tile indices are RELATIVE to the windowed operands; absolute
    ids ride the wbase scalar; the ``n`` scalar is clamped to the parked
    block's end (the pad-column guard)."""
    geom = geom if geom is not None else hp.Geometry()
    tile_m, tile_n = geom.tile_m, geom.tile_n
    b0 = (d + s) * ns  # global first row of the parked block
    blk_end = min(n, b0 + ns)
    row_base_t = (d * ns + s_w) // tile_m
    col_base_t = (b0 + c_off) // tile_n
    # vectorized like hamming_pallas._fill_scalars (a per-launch Python
    # loop is host time the sweep phases do not show)
    k = len(batch)
    if k == 0:
        return
    g_rt = np.fromiter((b[0] for b in batch), np.int64, count=k)
    g_ct0 = np.fromiter((b[1] for b in batch), np.int64, count=k)
    rel_rt = g_rt - row_base_t
    rel_ct = g_ct0 - col_base_t
    assert rel_rt.min() >= 0 and rel_rt.max() < w_rows // tile_m
    assert rel_ct.min() >= 0 and (
        int(rel_ct.max()) + geom.band_tiles
    ) * tile_n <= cw_rows, (int(rel_ct.max()), cw_rows)
    scal[:k, 0] = tolerance_int
    scal[:k, 1] = blk_end
    scal[:k, 2] = rel_rt
    scal[:k, 3] = rel_ct
    scal[:k, 4] = np.minimum(min_bound[g_rt], blk_end)
    scal[:k, 5] = max_row_lo[g_rt]
    scal[:k, 6] = col_base_t
    scal[:k, 7] = row_base_t  # in-kernel iota row_lo (self-search)


def _host_launch_pairs(
    packed: np.ndarray,
    bounds_c: np.ndarray,
    tolerance_int: int,
    g_rt: int,
    g_ct0: int,
    blk_end: int,
    out_i: list,
    out_j: list,
    geom: "hp.Geometry | None" = None,
) -> None:
    """Exact host recompute of one launch (phase-B extraction-capacity
    overflow fallback; NumPy popcount over the launch's rectangle)."""
    geom = geom if geom is not None else hp.Geometry()
    n = packed.shape[0]
    tile_m, tile_n, band = geom.tile_m, geom.tile_n, geom.band_tiles
    r0 = g_rt * tile_m
    r1 = min(r0 + tile_m, n)
    c0 = g_ct0 * tile_n
    c1 = min((g_ct0 + band) * tile_n, blk_end, n)
    if r0 >= n or c1 <= c0:
        return
    # ``packed`` may be a device-resident jax array (the
    # IncrementalDeviceLibrary path): fetch the two SMALL slices to host
    # first — broadcasting them on device would materialize a
    # [tile_m, band * tile_n, 32] uint32 temp (~2 GB) and push it d2h.
    rows_np = np.asarray(packed[r0:r1])
    cols_np = np.asarray(packed[c0:c1])
    dist = np.bitwise_count(
        rows_np[:, None, :] ^ cols_np[None, :, :]
    ).sum(axis=2)
    rows = np.arange(r0, r1)[:, None]
    cols = np.arange(c0, c1)[None, :]
    adj = (
        (dist <= tolerance_int)
        & (cols > rows)
        & (cols < bounds_c[r0:r1, None])
    )
    ii, jj = np.nonzero(adj)
    out_i.append(ii.astype(np.int64) + r0)
    out_j.append(jj.astype(np.int64) + c0)


def _decode_ring_shard(
    arr: np.ndarray,
    batch: list[tuple[int, int]],
    pb_calls: int,
    out_i: list,
    out_j: list,
    geom: "hp.Geometry | None" = None,
) -> bool:
    """One shard's phase-B result ([word locs | words | total]) -> global
    pairs.  Returns False on extraction-capacity overflow."""
    geom = geom if geom is not None else hp.Geometry()
    cap = RING_EXTRACT_CAP
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
    shape = (
        pb_calls,
        geom.r_tiles,
        geom.band_tiles,
        geom.tile_m // 32,
        geom.tile_n,
    )
    k, i, j, r, c = np.unravel_index(loc, shape)
    keep = k < len(batch)
    k, i, j, r, c, val = k[keep], i[keep], j[keep], r[keep], c[keep], val[keep]
    if k.size == 0:
        return True
    g_rts = np.array([b[0] for b in batch], dtype=np.int64)
    g_cts = np.array([b[1] for b in batch], dtype=np.int64)
    rbase = (g_rts[k] + i) * geom.tile_m + r * 32
    cbase = (g_cts[k] + j) * geom.tile_n + c
    bits = (val[:, None] >> np.arange(32, dtype=np.int64)[None, :]) & 1
    ww, bb = np.nonzero(bits)
    out_i.append(rbase[ww] + bb)
    out_j.append(cbase[ww])
    return True


def banded_adjacency_ring(
    packed: np.ndarray,
    bounds: np.ndarray,
    tolerance_int: int,
    mesh=None,
    axis: str = "x",
    window_rows: int | None = None,
    geom: "hp.Geometry | None" = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact banded adjacency over a device mesh (the two-phase ring).

    Same contract as ``ops.hamming.banded_adjacency``: all pairs (i, j)
    with i < j < bounds[i] and hamming(i, j) <= tolerance_int, in global
    lexicographic order — the host greedy replay produces groups
    identical to the single-device backends.

    ``window_rows`` (or VDF_RING_WINDOW_ROWS) bounds each shard's
    resident +/-1 operands to a sliding row window — the ring x window
    composition for libraries whose per-shard +/-1 expansion exceeds the
    device budget.  Default: one window spanning the shard.
    """
    import jax.numpy as jnp

    t_setup = time.perf_counter()
    n = packed.shape[0]
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    geom = geom if geom is not None else hp.Geometry()
    assert geom.r_tiles == 1, (
        "the ring backend assumes single-row-tile chunks"
    )
    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh(axis=axis)
    launch = hp.sweep_launch()
    on_cpu = platform.backend() == "cpu"

    n_dev = int(mesh.devices.size)
    align = _align(geom)
    tile_m, tile_n = geom.tile_m, geom.tile_n

    # shard/window sizing shared with the ring_capacity_ok veto (one
    # rule, one place — for the default's budget
    # derivation; the veto desync hazard is why it is not inlined here)
    ns, bounds_c, w_rows, cw_rows = _ring_window_plan(
        n, bounds, n_dev, geom, window_rows
    )
    npad = ns * n_dev
    n_win = -(-ns // w_rows)
    w_starts = [min(w * w_rows, ns - w_rows) for w in range(n_win)]

    # per-row-tile metadata (global), vectorized: full tiles reduce in
    # one reshape, the partial tail tile separately; tiles past n keep
    # (0, sentinel)
    n_tiles = npad // tile_m
    min_bound = np.zeros(n_tiles, dtype=np.int64)
    max_row_lo = np.full(n_tiles, hp._ROW_LO_SENTINEL, dtype=np.int64)
    nt_full = n // tile_m
    if nt_full:
        min_bound[:nt_full] = (
            bounds_c[: nt_full * tile_m].reshape(-1, tile_m).min(axis=1)
        )
        max_row_lo[:nt_full] = (
            np.arange(1, nt_full + 1, dtype=np.int64) * tile_m - 1
        )
    if nt_full * tile_m < n:
        min_bound[nt_full] = int(bounds_c[nt_full * tile_m :].min())

    launches, k_max = _plan_ring_launches(
        n, n_dev, ns, bounds_c, w_rows, n_win, geom
    )

    # The windowed +/-1 operands materialize ONCE per (step, window)
    # via operands_fn and are shared by every launch batch of that
    # window; batch sizes chunk largest-fitting-first so padding waste
    # stays under the smallest bucket.
    # CPU test sizes on the CPU backend
    sweep_buckets = (8,) if on_cpu else (1024, 64)
    pb_buckets = (4,) if on_cpu else (64, 16)
    operands_fn, _, _, rotate_fn, shard_fn, operands0_fn = _ring_jits(
        axis, mesh, launch, sweep_buckets[0], pb_buckets[0],
        w_rows, cw_rows, ns, geom,
    )

    def fns_for(size, pb=False):
        got = _ring_jits(
            axis, mesh, launch,
            size if not pb else sweep_buckets[0],
            size if pb else pb_buckets[0],
            w_rows, cw_rows, ns, geom,
        )
        return got[2] if pb else got[1]

    def pick(buckets_desc, rem):
        return next(
            (b for b in buckets_desc if b <= rem), buckets_desc[-1]
        )

    # sharded device state.  ``packed`` may be a device-resident jax
    # array (e.g. an IncrementalDeviceLibrary gather) — padding then
    # happens on device and no library bytes ride h2d.
    if isinstance(packed, np.ndarray):
        packed_pad = np.zeros((npad, 32), np.uint32)
        packed_pad[:n] = packed
        own_pk = shard_fn(packed_pad)
    elif npad == n:
        # aligned device-resident library: no pad needed — skip the
        # concat, which would otherwise copy the whole packed buffer per
        # call
        own_pk = shard_fn(packed)
    else:
        own_pk = shard_fn(
            jnp.concatenate(
                [packed[:n], jnp.zeros((npad - n, 32), jnp.uint32)]
            )
        )
    # row metadata in the compact [rows // 128, 128] layout; row_lo is
    # just the clipped row index — built on device
    bounds_np = np.full(npad, -1, np.int32)
    bounds_np[:n] = bounds_c
    bounds_dev = shard_fn(bounds_np.reshape(-1, 128))
    # self-search row_lo comes from the in-kernel iota (the row-base
    # scalar); the operand slot aliases bounds and is never read
    row_lo_dev = bounds_dev

    n_scal = geom.n_scal
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    col_pk = own_pk

    # retain phase-A operands for phase B only when ONE window spans the
    # shard — with several windows, keeping them all alive would defeat
    # the windowing's memory bound (the per-(step, window) operand
    # REBUILD for phase B is otherwise a visible cost)
    cache_ops = n_win == 1
    ph = {"operands": 0.0, "dispatch": 0.0, "drain": 0.0, "phase_b": 0.0,
          "rotate": 0.0, "op_builds": 0, "op_reuses": 0, "batches": 0,
          "steps": 0, "windows": n_win, "window_rows": w_rows,
          # host/h2d work before the step loop: metadata h2d, per-tile
          # metadata reductions, launch planning, jit retrieval
          "setup": time.perf_counter() - t_setup}

    def build_ops(s, w, col_blk):
        t0 = time.perf_counter()
        ph["op_builds"] += 1
        s_w = w_starts[w]
        c_off = s_w if s == 0 else 0
        try:
            if s == 0:
                # step 0 parks the shard's own block: the row window is
                # a prefix of the column window — one unpack serves both
                cols_pm, b, r = operands0_fn(
                    own_pk, col_blk, bounds_dev, row_lo_dev,
                    jnp.int32(s_w), jnp.int32(c_off),
                )
                return (cols_pm, cols_pm, b, r)
            return operands_fn(
                own_pk, col_blk, bounds_dev, row_lo_dev,
                jnp.int32(s_w), jnp.int32(c_off),
            )
        finally:
            ph["operands"] += time.perf_counter() - t0

    def dispatch_step(s, col_pk_s):
        # ---- phase A: counts over every launch of this ring step
        step_pending: list[tuple[int, dict[int, list], int, object]] = []
        ops_cache: dict[int, tuple] = {}
        for w in range(n_win):
            per_shard = {
                d: launches.get((s, w, d), []) for d in range(n_dev)
            }
            total = max((len(v) for v in per_shard.values()), default=0)
            if total == 0:
                continue
            s_w = w_starts[w]
            c_off = s_w if s == 0 else 0
            ops = build_ops(s, w, col_pk_s)
            if cache_ops:
                ops_cache[w] = ops
            b0 = 0
            while b0 < total:
                size = pick(sweep_buckets, total - b0)
                scal_np = np.zeros((n_dev, size, n_scal), np.int32)
                scal_np[:, :, 0] = -1  # padded launches match nothing
                batch_by_shard: dict[int, list] = {}
                for d in range(n_dev):
                    batch = per_shard[d][b0 : b0 + size]
                    if not batch:
                        continue
                    batch_by_shard[d] = batch
                    _fill_ring_scalars(
                        scal_np[d], batch, d, s, ns, n, s_w, c_off,
                        tolerance_int, min_bound, max_row_lo,
                        w_rows, cw_rows, geom,
                    )
                t0 = time.perf_counter()
                counts = fns_for(size)(*ops, jnp.asarray(scal_np))
                ph["dispatch"] += time.perf_counter() - t0
                ph["batches"] += 1
                step_pending.append((w, batch_by_shard, size, counts))
                b0 += size
            ops = None  # free this window's operands (counts hold them
            # alive on device only until their executions finish)
        return step_pending, ops_cache

    def finish_step(s, step_pending, ops_cache, col_pk_s):
        # ---- drain counts; collect hit launches per (w, d).  All of
        # the step's count blocks ride ONE d2h via a device-side concat
        # instead of one round trip per batch
        t0 = time.perf_counter()
        hits: dict[tuple[int, int], list[tuple[int, int]]] = {}
        if step_pending:
            flat = np.asarray(
                jnp.concatenate(
                    [
                        c.reshape(n_dev, -1)
                        for _w, _b, _s, c in step_pending
                    ],
                    axis=1,
                )
            )
            off = 0
            for w, batch_by_shard, size, _counts in step_pending:
                width = size * geom.r_tiles
                cnp = flat[:, off : off + width].reshape(
                    n_dev, size, geom.r_tiles
                )
                off += width
                for d, k in zip(*np.nonzero(cnp.sum(axis=2) > 0)):
                    batch = batch_by_shard.get(int(d), [])
                    if int(k) < len(batch):
                        hits.setdefault((w, int(d)), []).append(
                            batch[int(k)]
                        )
        ph["drain"] += time.perf_counter() - t0

        # ---- phase B: re-run hit launches with the packing kernel.
        # Dispatch EVERY batch first, then decode from ONE concatenated
        # d2h fetch — the fixed [n_dev, 2*CAP+1] output shape makes the
        # whole step's extractions a single round trip
        t_b = time.perf_counter()
        by_window: dict[int, dict[int, list]] = {}
        for (w, d), lst in hits.items():
            by_window.setdefault(w, {})[d] = lst
        pb_pending: list[tuple[object, dict[int, list], int]] = []
        for w, shard_hits in sorted(by_window.items()):
            s_w = w_starts[w]
            c_off = s_w if s == 0 else 0
            # phase A's operands for this window are identical (col_pk_s
            # is the pre-rotation handle) — reuse when retained
            ops = ops_cache.get(w)
            if ops is not None:
                ph["op_reuses"] += 1
            else:
                ops = build_ops(s, w, col_pk_s)
            total = max(len(v) for v in shard_hits.values())
            b0 = 0
            while b0 < total:
                size = pick(pb_buckets, total - b0)
                scal_np = np.zeros((n_dev, size, n_scal), np.int32)
                scal_np[:, :, 0] = -1
                batch_by_shard = {}
                for d, lst in shard_hits.items():
                    batch = lst[b0 : b0 + size]
                    if not batch:
                        continue
                    batch_by_shard[d] = batch
                    _fill_ring_scalars(
                        scal_np[d], batch, d, s, ns, n, s_w, c_off,
                        tolerance_int, min_bound, max_row_lo,
                        w_rows, cw_rows, geom,
                    )
                b0 += size
                out = fns_for(size, pb=True)(*ops, jnp.asarray(scal_np))
                pb_pending.append((out, batch_by_shard, size))
        if pb_pending:
            flat = np.asarray(
                jnp.concatenate([o for o, _b, _s in pb_pending], axis=1)
            )
            width = flat.shape[1] // len(pb_pending)
            for k, (_o, batch_by_shard, size) in enumerate(pb_pending):
                arr = flat[:, k * width : (k + 1) * width]
                for d, batch in batch_by_shard.items():
                    if not _decode_ring_shard(
                        arr[d], batch, size, out_i, out_j, geom
                    ):
                        # extraction overflow: exact host recompute
                        blk_end = min(n, (d + s + 1) * ns)
                        for g_rt, g_ct0 in batch:
                            _host_launch_pairs(
                                packed, bounds_c, tolerance_int,
                                g_rt, g_ct0, blk_end, out_i, out_j,
                                geom,
                            )
        ph["phase_b"] += time.perf_counter() - t_b
        ops_cache.clear()  # release this step's retained operands

    # Depth-1 software pipeline (VDF_RING_PIPELINE=1): dispatch step
    # s+1's phase-A counts BEFORE draining step s, so the device stays
    # fed while the host fills launch scalars, rides the counts /
    # extraction d2h round trips, and decodes pairs.  Costs one extra
    # step of live counts buffers (and, when n_win == 1, a second
    # step's retained +/-1 operands); off by default, not measured on
    # this card.
    pipelined = os.environ.get("VDF_RING_PIPELINE", "0") == "1"
    prev = None
    for s in range(k_max + 1):
        step_pending, ops_cache = dispatch_step(s, col_pk)
        # rotate early: the next step's column block moves while this
        # step's counts drain and phase B runs (phase B keeps using the
        # old col_pk handle)
        col_pk_s = col_pk
        if s < k_max:
            t0 = time.perf_counter()
            col_pk = rotate_fn(col_pk)
            ph["rotate"] += time.perf_counter() - t0
        ph["steps"] += 1
        if pipelined:
            if prev is not None:
                finish_step(*prev)
            prev = (s, step_pending, ops_cache, col_pk_s)
        else:
            finish_step(s, step_pending, ops_cache, col_pk_s)
    if prev is not None:
        finish_step(*prev)

    global LAST_RING_PHASES
    LAST_RING_PHASES = dict(ph)
    if os.environ.get("VDF_RING_DEBUG") == "1":
        import sys

        print(
            "# ring phases: "
            + " ".join(
                f"{k}={v:.3f}s" if isinstance(v, float) else f"{k}={v}"
                for k, v in ph.items()
            ),
            file=sys.stderr,
        )

    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]
