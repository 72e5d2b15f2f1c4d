"""Multi-device references-vs-candidates search: refs sharded over a mesh.

The multi-device path of ``search_with_references`` (semantics:
``video_dup_finder.rs:19-46``).  Parallelization choice — the opposite
axis from the self-search ring, because it needs no collectives in the
hot loop:

* REFS are sharded over a 1D ``jax.sharding.Mesh``: duration-sorted refs
  split contiguously, shard ``d`` owning rows ``[d*r_sh, (d+1)*r_sh)``.
  Each shard's refs cover a contiguous duration range, so its candidate
  bands are a contiguous slab of the sorted candidate axis.
* The PACKED candidate library (128 B/hash) is REPLICATED — 4 GB at 32M
  hashes, far under device memory — while the 1 KB/hash +/-1 expansion exists only
  as a per-shard sliding COLUMN window over each shard's own band slab
  (``jax.lax.dynamic_slice`` at a per-shard offset).  Per-chip live
  memory is O(window + refs/devices), and there is ZERO inter-device traffic
  after the initial replication: no ppermute, no collectives in the hot
  loop — embarrassing data parallelism, which XLA schedules perfectly.
* Each shard runs the same two-phase banded sweep as every other backend
  (counts kernel over all launches, packing kernel + fused word
  extraction over hit launches) via ``shard_map`` with per-shard launch
  scalars, reusing ``ring_pallas``'s SPMD counts/pack closures.

Exactness: pairs emerge in global lexicographic order after the final
sort; planted-pair and oracle parity are pinned by
``tests/test_refs_sharded.py``.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np

from .. import platform
from ..ops import hamming_pallas as hp
from . import ring_pallas as rp

LAST_PHASES: dict = {}


def _pow2_tiles(k_tiles: int) -> int:
    return 1 << (max(1, k_tiles) - 1).bit_length()


def refs_adjacency_sharded(
    refs_packed: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    tolerance_int: int,
    cands_packed: np.ndarray | None = None,
    cands_dev=None,
    n_cands: int | None = None,
    mesh=None,
    axis: str = "x",
    window_rows: int | None = None,
    geom: "hp.Geometry | None" = None,
) -> tuple[np.ndarray, np.ndarray]:
    """All pairs (i, j): i a refs row, lo[i] <= j < hi[i], hamming <=
    tolerance_int — lexicographic, output-identical to
    ``refs_adjacency_windowed`` / ``refs_adjacency_pallas``, computed
    refs-sharded over ``mesh``.  ``refs_packed`` must be duration-sorted
    (lo/hi monotone) for contiguous per-shard band slabs."""
    import jax.numpy as jnp

    geom = geom if geom is not None else hp.Geometry()
    TILE_M, TILE_N, R_TILES, BAND_TILES = geom
    assert R_TILES == 1, "refs search assumes single-row-tile chunks"
    r = refs_packed.shape[0]
    n = int(n_cands) if cands_dev is not None else cands_packed.shape[0]
    if r == 0 or n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)

    if mesh is None:
        from .mesh import make_mesh

        mesh = make_mesh(axis=axis)
    launch = hp.sweep_launch()
    on_cpu = platform.backend() == "cpu"
    n_dev = int(mesh.devices.size)

    # refs rows: equal per-shard slabs, power-of-two tiles per shard
    r_sh_tiles = _pow2_tiles(-(-(-(-r // n_dev)) // TILE_M))
    r_sh = r_sh_tiles * TILE_M
    r_pad = r_sh * n_dev
    refs_pad = np.zeros((r_pad, 32), np.uint32)
    refs_pad[:r] = refs_packed
    bounds_np = np.full((r_pad, 1), -1, dtype=np.int32)
    bounds_np[:r, 0] = np.minimum(hi, n)
    row_lo_np = np.full((r_pad, 1), hp._ROW_LO_SENTINEL, dtype=np.int32)
    row_lo_np[:r, 0] = np.maximum(lo, 0) - 1

    # per-tile metadata (global tile ids; sentinels on partial tiles)
    n_tiles = r_pad // TILE_M
    first_ct = np.zeros(n_tiles, dtype=np.int64)
    n_ct = np.zeros(n_tiles, dtype=np.int64)
    min_bound = np.zeros(n_tiles, dtype=np.int64)
    max_row_lo = np.full(n_tiles, hp._ROW_LO_SENTINEL, dtype=np.int64)
    for rt in range(n_tiles):
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

    # candidate axis: replicated packed, per-shard sliding +/-1 window
    n_cpad = -(-max(n, 1) // TILE_N) * TILE_N + (BAND_TILES + 1) * TILE_N
    align = TILE_N
    cap_rows = (
        int(window_rows)
        if window_rows
        else int(os.environ.get("VDF_REFS_WINDOW_ROWS", str(1 << 21)))
    )
    cap_tiles = max(-(-cap_rows // TILE_N), BAND_TILES + 1)
    need_tiles = -(-n_cpad // TILE_N)
    w_tiles = _pow2_tiles(min(need_tiles, cap_tiles))
    w_rows = w_tiles * TILE_N
    need = -(-n_cpad // align) * align + w_rows
    max_ct = (n_cpad - TILE_N) // TILE_N
    clamp = max_ct - BAND_TILES
    wmax = need - w_rows

    if cands_dev is not None:
        pad = jnp.zeros((need - n, 32), jnp.uint32)
        packed_rep = jnp.concatenate([cands_dev[:n], pad])
    else:
        packed_np = np.zeros((need, 32), np.uint32)
        packed_np[:n] = cands_packed[:n]
        packed_rep = jnp.asarray(packed_np)

    # ---- host planner: per-shard launches, grouped into window slots
    # (each shard slides its OWN window over its band slab; a slot is
    # one SPMD round across shards)
    per_shard_launches: list[list[tuple[int, int]]] = []
    for d in range(n_dev):
        lst: list[tuple[int, int]] = []
        for rt_local in range(r_sh_tiles):
            g_rt = d * r_sh_tiles + rt_local
            nc = int(n_ct[g_rt])
            if nc <= 0:
                continue
            ct0 = int(first_ct[g_rt])
            lst.extend(
                (g_rt, min(ct0 + s, clamp))
                for s in range(0, nc, BAND_TILES)
            )
        lst.sort(key=lambda b: b[1])  # column-major: monotone window
        per_shard_launches.append(lst)

    # slot assignment per shard: greedy monotone windows
    per_shard_slots: list[list[tuple[int, list]]] = []
    for d in range(n_dev):
        out: list[tuple[int, list]] = []
        cur_w = None
        cur: list[tuple[int, int]] = []
        for g_rt, ct0 in per_shard_launches[d]:
            c_lo = ct0 * TILE_N
            c_end = (ct0 + BAND_TILES) * TILE_N
            if cur_w is None or c_lo < cur_w or c_end - cur_w > w_rows:
                if cur:
                    out.append((cur_w, cur))
                cur_w = min((c_lo // align) * align, wmax)
                cur = []
            cur.append((g_rt, ct0))
        if cur:
            out.append((cur_w, cur))
        per_shard_slots.append(out)
    max_slots = max((len(s) for s in per_shard_slots), default=0)

    # ---- SPMD jits (counts/pack bodies shared with the ring backend)
    # CPU test sizes on the CPU backend
    sweep_buckets = (8,) if on_cpu else (1024, 64)
    pb_buckets = (4,) if on_cpu else (64, 16)
    jits = rp._ring_jits(
        axis, mesh, launch, sweep_buckets[0], pb_buckets[0],
        w_rows, need, r_sh, geom,
    )
    shard_fn = jits[4]

    def fns_for(size, pb=False):
        got = rp._ring_jits(
            axis, mesh, launch,
            size if not pb else sweep_buckets[0],
            size if pb else pb_buckets[0],
            w_rows, need, r_sh, geom,
        )
        return got[2] if pb else got[1]

    def pick(buckets_desc, rem):
        return next((b for b in buckets_desc if b <= rem), buckets_desc[-1])

    window_fn = _window_jits(axis, mesh, w_rows, need, geom)

    rows_pm = shard_fn(_unpack_host_free(refs_pad))
    bounds_dev = shard_fn(bounds_np)
    row_lo_dev = shard_fn(row_lo_np)

    n_scal = geom.n_scal
    out_i: list[np.ndarray] = []
    out_j: list[np.ndarray] = []
    ph = {"windows": 0.0, "dispatch": 0.0, "drain": 0.0, "phase_b": 0.0,
          "slots": 0, "batches": 0}

    def fill(scal, batch, d, w_start):
        # vectorized launch-scalar fill (same as
        # ring_pallas._fill_ring_scalars)
        w_tn = w_start // TILE_N
        k = len(batch)
        ba = np.asarray(batch, dtype=np.int64).reshape(k, 2)
        g_rts, ct0s = ba[:, 0], ba[:, 1]
        scal[:k, 0] = tolerance_int
        scal[:k, 1] = n
        scal[:k, 2] = g_rts - d * r_sh_tiles  # local refs tile
        scal[:k, 3] = ct0s - w_tn
        scal[:k, 4] = min_bound[g_rts]
        scal[:k, 5] = max_row_lo[g_rts]
        scal[:k, 6] = w_tn
        scal[:k, 7] = -1  # row_lo from the per-ref operand

    for slot in range(max_slots):
        cur = {
            d: per_shard_slots[d][slot]
            for d in range(n_dev)
            if slot < len(per_shard_slots[d])
        }
        offs = np.zeros((n_dev, 1), np.int32)
        for d, (w_start, _) in cur.items():
            offs[d, 0] = w_start
        t0 = time.perf_counter()
        cols_pm = window_fn(packed_rep, shard_fn(offs))
        ph["windows"] += time.perf_counter() - t0
        ph["slots"] += 1

        total = max(len(lst) for (_, lst) in cur.values())
        pending = []
        b0 = 0
        while b0 < total:
            size = pick(sweep_buckets, total - b0)
            scal_np = np.zeros((n_dev, size, n_scal), np.int32)
            scal_np[:, :, 0] = -1
            batch_by_shard = {}
            for d, (w_start, lst) in cur.items():
                batch = lst[b0 : b0 + size]
                if not batch:
                    continue
                batch_by_shard[d] = batch
                fill(scal_np[d], batch, d, w_start)
            t0 = time.perf_counter()
            counts = fns_for(size)(
                rows_pm, cols_pm, bounds_dev, row_lo_dev,
                jnp.asarray(scal_np),
            )
            ph["dispatch"] += time.perf_counter() - t0
            ph["batches"] += 1
            pending.append((batch_by_shard, size, counts))
            b0 += size

        # drain counts; collect hit launches per shard.  ONE concatenated
        # d2h for the whole slot instead of one round trip per batch
        t0 = time.perf_counter()
        hits: dict[int, list[tuple[int, int]]] = {}
        if pending:
            flat = np.asarray(
                jnp.concatenate(
                    [c.reshape(n_dev, -1) for (_, _, c) in pending],
                    axis=1,
                )
            )
            off = 0
            for batch_by_shard, size, _counts in pending:
                w = size * R_TILES
                cnp = flat[:, off : off + w].reshape(n_dev, size, R_TILES)
                off += w
                for d, k in zip(*np.nonzero(cnp.sum(axis=2) > 0)):
                    batch = batch_by_shard.get(int(d), [])
                    if int(k) < len(batch):
                        hits.setdefault(int(d), []).append(batch[int(k)])
        ph["drain"] += time.perf_counter() - t0

        # phase B over the hit launches, same cols windows.  Dispatch
        # every batch first, then ONE concatenated d2h fetch for the
        # slot
        t0 = time.perf_counter()
        if hits:
            total = max(len(v) for v in hits.values())
            pb_pending = []
            b0 = 0
            while b0 < total:
                size = pick(pb_buckets, total - b0)
                scal_np = np.zeros((n_dev, size, n_scal), np.int32)
                scal_np[:, :, 0] = -1
                batch_by_shard = {}
                for d, lst in hits.items():
                    batch = lst[b0 : b0 + size]
                    if not batch:
                        continue
                    batch_by_shard[d] = batch
                    fill(scal_np[d], batch, d, cur[d][0])
                b0 += size
                out = fns_for(size, pb=True)(
                    rows_pm, cols_pm, bounds_dev, row_lo_dev,
                    jnp.asarray(scal_np),
                )  # [n_dev, 2 * CAP + 1]
                pb_pending.append((batch_by_shard, size, out))
            flat = np.asarray(
                jnp.concatenate([o for (_, _, o) in pb_pending], axis=1)
            )
            off = 0
            for batch_by_shard, size, out in pb_pending:
                w = out.shape[1]
                arr = flat[:, off : off + w]
                off += w
                for d, batch in batch_by_shard.items():
                    if not rp._decode_ring_shard(
                        arr[d], batch, size, out_i, out_j, geom
                    ):
                        # extraction overflow: exact host recompute of
                        # this shard's batch over the replicated packed
                        for g_rt, ct0 in batch:
                            _host_refs_launch(
                                refs_pad, packed_rep, lo, hi,
                                tolerance_int, g_rt, ct0, n, geom,
                                out_i, out_j,
                            )
        ph["phase_b"] += time.perf_counter() - t0
        cols_pm = None

    global LAST_PHASES
    LAST_PHASES = dict(ph)

    if not out_i:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ii = np.concatenate(out_i)
    jj = np.concatenate(out_j)
    keep = ii < r  # pad refs rows have bounds -1 and never match
    ii, jj = ii[keep], jj[keep]
    order = np.lexsort((jj, ii))
    return ii[order], jj[order]


def _unpack_host_free(refs_pad: np.ndarray) -> np.ndarray:
    """Host +/-1 expansion of the (small) refs rows — 1 KB/hash for r
    rows only, shipped once via the sharded device_put."""
    bits = (
        refs_pad[:, :, None]
        >> np.arange(32, dtype=np.uint32)[None, None, :]
    ) & np.uint32(1)
    pm = bits.astype(np.int8).reshape(refs_pad.shape[0], 1024) * 2 - 1
    if hp.PM_DTYPE != "int8":
        import jax.numpy as jnp

        pm = pm.astype(jnp.bfloat16)  # ml_dtypes bfloat16 numpy dtype
    return pm


@functools.cache
def _window_jits(axis, mesh, w_rows, need, geom):
    """Per-shard column-window build: each shard slices its OWN window
    of the replicated packed candidates at its sharded offset."""
    from ..utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    import math

    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def body(packed_rep, off):
        at = off[0, 0]
        pk = jax.lax.dynamic_slice(packed_rep, (at, 0), (w_rows, 32))
        # shared chunked-scan unpack: ops/hamming_pallas.unpack_pm_scan
        return hp.unpack_pm_scan(pk, math.gcd(w_rows, 4096))

    return jax.jit(
        shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(axis, None)),
            out_specs=P(axis, None),
            check_vma=False,
        )
    )


def _host_refs_launch(
    refs_pad, packed_rep, lo, hi, tolerance_int, g_rt, ct0, n, geom,
    out_i, out_j,
) -> None:
    """Exact host recompute of one refs launch (extraction overflow)."""
    TILE_M, TILE_N, _R, BAND_TILES = geom
    r0 = g_rt * TILE_M
    r1 = min(r0 + TILE_M, lo.shape[0])
    c0 = ct0 * TILE_N
    c1 = min((ct0 + BAND_TILES) * TILE_N, n)
    if r0 >= lo.shape[0] or c1 <= c0:
        return
    rows_np = np.asarray(refs_pad[r0:r1])
    cols_np = np.asarray(packed_rep[c0:c1])
    dist = np.bitwise_count(
        rows_np[:, None, :] ^ cols_np[None, :, :]
    ).sum(axis=2)
    cols = np.arange(c0, c1)[None, :]
    adj = (
        (dist <= tolerance_int)
        & (cols >= lo[r0:r1, None])
        & (cols < np.minimum(hi[r0:r1, None], n))
    )
    ii, jj = np.nonzero(adj)
    out_i.append(ii.astype(np.int64) + r0)
    out_j.append(jj.astype(np.int64) + c0)
