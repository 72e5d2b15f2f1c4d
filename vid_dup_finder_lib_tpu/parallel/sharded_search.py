"""Sharded hash generation and ring all-pairs candidate scan.

Multi-device layout (SURVEY.md section 2.7): the hash *batch* axis is data
parallel; the all-pairs search shards the library axis N — each device holds
a row block of the +/-1 hash matrix, and column blocks rotate around the
ring with ``jax.lax.ppermute`` so every chip computes its row-block-vs-
rotating-column-block distance tile each step.  O(N^2 / n_devices) matmul
work per device with the permute overlapped by XLA.

Two scan variants share the ring layout:

* ``ring_candidate_scan`` — fixed-shape per-row statistics (match count,
  best-match distance/index): the cheap probe for N too large to
  materialize adjacency.
* ``banded_adjacency_ring`` (in ``ring_pallas``, re-exported here) —
  EXACT pair extraction at production scale: the two-phase int8 banded
  sweep runs per shard against packed column blocks rotated with
  ``ppermute``, with block-level band skipping and sliding row
  windows.  This is the multi-device backend behind
  ``search(..., backend="ring")`` — groups identical to the
  single-device paths.
"""

from __future__ import annotations

import functools

import numpy as np

from ..definitions import (
    HASH_BITS,
    HASH_BITS_PADDED,
    SELF_SEARCH_DURATION_FACTOR,
)


def _unpack_pm1_jnp(packed):
    import jax.numpy as jnp

    k = packed.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (packed[:, :, None] >> shifts) & jnp.uint32(1)
    pm = bits.astype(jnp.int8).reshape(k, HASH_BITS_PADDED) * 2 - 1
    return pm.astype(jnp.bfloat16)  # all 1024 storage bits count


@functools.cache
def _build_ring_scan(axis: str):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def ring_body(packed_local, durs_local, ids_local, tol):
        """Runs per-shard inside shard_map.

        packed_local: uint32[Ns, 32]; durs_local/ids_local: int32[Ns, 1].
        Returns per-row (count, best_dist, best_idx) over ALL columns.
        """
        n_dev = jax.lax.psum(1, axis)
        pm_local = _unpack_pm1_jnp(packed_local)  # [Ns, 1024] bf16

        # duration window threshold per local row (trunc, as the reference)
        thresh = (
            durs_local.astype(jnp.float32) * SELF_SEARCH_DURATION_FACTOR
        ).astype(jnp.int32)

        def step(s, carry):
            counts, best_dist, best_idx, blk_pm, blk_durs, blk_ids = carry
            dot = jax.lax.dot_general(
                pm_local, blk_pm,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            dist = ((HASH_BITS_PADDED - dot) * 0.5).astype(jnp.int32)
            valid = (
                (blk_ids[:, 0][None, :] > ids_local)
                & (blk_durs[:, 0][None, :] <= thresh)
                & (dist <= tol)
            )
            counts = counts + jnp.sum(valid, axis=1, dtype=jnp.int32)[:, None]
            masked = jnp.where(valid, dist, HASH_BITS + 1)
            blk_best = jnp.min(masked, axis=1)
            blk_arg = jnp.take(
                blk_ids[:, 0], jnp.argmin(masked, axis=1), axis=0
            )
            better = blk_best[:, None] < best_dist
            best_idx = jnp.where(better, blk_arg[:, None], best_idx)
            best_dist = jnp.minimum(best_dist, blk_best[:, None])
            # rotate the column block to the next chip on the ring
            perm = [(d, (d + 1) % n_dev) for d in range(n_dev)]
            blk_pm = jax.lax.ppermute(blk_pm, axis, perm)
            blk_durs = jax.lax.ppermute(blk_durs, axis, perm)
            blk_ids = jax.lax.ppermute(blk_ids, axis, perm)
            return (counts, best_dist, best_idx, blk_pm, blk_durs, blk_ids)

        ns = pm_local.shape[0]
        # constants must be marked device-varying for the shard_map carry
        pvary = lambda x: jax.lax.pcast(x, (axis,), to="varying")  # noqa: E731
        init = (
            pvary(jnp.zeros((ns, 1), jnp.int32)),
            pvary(jnp.full((ns, 1), HASH_BITS + 1, jnp.int32)),
            pvary(jnp.full((ns, 1), -1, jnp.int32)),
            pm_local,
            durs_local,
            ids_local,
        )
        counts, best_dist, best_idx, *_ = jax.lax.fori_loop(
            0, n_dev, step, init
        )
        return counts, best_dist, best_idx

    def make(mesh):
        return shard_map(
            ring_body,
            mesh=mesh,
            in_specs=(P(axis, None), P(axis, None), P(axis, None), P()),
            out_specs=(P(axis, None), P(axis, None), P(axis, None)),
        )

    return make


@functools.cache
def _jitted_ring_scan(axis: str, mesh):
    """jit-wrapped ring scan cached per (axis, mesh): a fresh shard_map +
    jit per call retraced every invocation)."""
    import jax

    return jax.jit(_build_ring_scan(axis)(mesh))


def ring_candidate_scan(
    mesh,
    packed: np.ndarray,
    durations: np.ndarray,
    tolerance_int: int,
    axis: str = "x",
):
    """All-pairs duplicate-candidate scan sharded over ``mesh``.

    ``packed`` must be sorted by duration (the Search order).  Returns
    (counts, best_dist, best_idx) per row, where candidates j satisfy
    j > i and dur_j <= int(1.1 * dur_i) and hamming <= tolerance (the
    search_self window, search_algorithm.rs:93-117).
    """
    import jax
    import jax.numpy as jnp

    n = packed.shape[0]
    n_dev = mesh.devices.size
    ns = -(-n // n_dev) * n_dev

    packed_pad = np.zeros((ns, packed.shape[1]), np.uint32)
    packed_pad[:n] = packed
    durs = np.full((ns, 1), -(10**9), np.int32)
    durs[:n, 0] = durations
    # pad COLUMN id must fail the `cand_id > row_id` test for every real
    # row, so it must sit BELOW all ids: -1 (a high sentinel passed the
    # id and duration tests, leaving only the distance test — which an
    # all-zero pad hash can pass against low-popcount rows)
    ids = np.full((ns, 1), -1, np.int32)
    ids[:n, 0] = np.arange(n)

    fn = _jitted_ring_scan(axis, mesh)
    with mesh:
        counts, best_dist, best_idx = fn(
            jnp.asarray(packed_pad),
            jnp.asarray(durs),
            jnp.asarray(ids),
            jnp.int32(tolerance_int),
        )
    return (
        np.asarray(counts)[:n, 0],
        np.asarray(best_dist)[:n, 0],
        np.asarray(best_idx)[:n, 0],
    )


# The exact-pair ring backend lives in ``ring_pallas`` (round 3): the
# int8 banded Pallas sweep composed with packed-block ppermute rotation
# and sliding row windows.  Re-exported here for compatibility.
from .ring_pallas import banded_adjacency_ring  # noqa: E402,F401


@functools.cache
def _build_sharded_hash(axis: str):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..definitions import DCT_SIZE, HASH_SIZE
    from ..ops.golden import dct2_matrix

    dct_np = dct2_matrix(DCT_SIZE, np.float32)

    def hash_shard(cubes):
        """uint8[Bs, 16, 16, 16] -> uint32[Bs, 32] on each chip."""
        hi = jax.lax.Precision.HIGHEST  # match hash_kernel bits
        dct = jnp.asarray(dct_np)
        x = cubes.astype(jnp.float32).transpose(0, 1, 3, 2) - 128.0
        x = jnp.einsum("ky,btxy->btxk", dct, x, precision=hi)
        x = jnp.einsum("jx,btxk->btjk", dct, x, precision=hi)
        x = jnp.einsum("it,btjk->bijk", dct, x, precision=hi)
        corner = x[:, :HASH_SIZE, :HASH_SIZE, :HASH_SIZE]
        bits = (corner > 0.0).reshape(cubes.shape[0], HASH_SIZE**3)
        padded = jnp.pad(bits, ((0, 0), (0, HASH_BITS_PADDED - HASH_SIZE**3)))
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[
            None, None, :
        ]
        return jnp.sum(
            padded.reshape(
                cubes.shape[0], HASH_BITS_PADDED // 32, 32
            ).astype(jnp.uint32)
            * weights,
            axis=-1,
            dtype=jnp.uint32,
        )

    def make(mesh):
        return shard_map(
            hash_shard,
            mesh=mesh,
            in_specs=(P(axis, None, None, None),),
            out_specs=P(axis, None),
        )

    return make


@functools.cache
def _jitted_sharded_hash(axis: str, mesh):
    import jax

    return jax.jit(_build_sharded_hash(axis)(mesh))


def sharded_hash_batch(mesh, cubes: np.ndarray, axis: str = "x") -> np.ndarray:
    """Data-parallel batched hashing over the mesh: each chip hashes its
    shard of the video batch (uint8[B, 16, 16, 16] -> uint32[B, 32])."""
    import jax.numpy as jnp

    b = cubes.shape[0]
    n_dev = mesh.devices.size
    b_pad = -(-b // n_dev) * n_dev
    if b_pad != b:
        cubes = np.concatenate(
            [cubes, np.zeros((b_pad - b,) + cubes.shape[1:], np.uint8)]
        )
    fn = _jitted_sharded_hash(axis, mesh)
    with mesh:
        out = fn(jnp.asarray(cubes))
    return np.asarray(out)[:b]
