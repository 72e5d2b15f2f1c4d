"""Resident-sweep kernel probe / large-N scale bench: device-born library.

Times the banded Pallas sweep over a library generated on device
(``jax.random.bits`` -> packed uint32 rows), so tile-geometry experiments
and multi-million-hash scale points don't pay the library h2d.  Random hashes sit at Hamming ~500 and never match at tolerance 350;
set VDF_PROBE_PLANT=K to overwrite K clusters of 3 near-duplicate rows
(device scatter) and assert every planted pair is recovered — the
correctness check for the windowed path at sizes where the +/-1 operand
matrix exceeds HBM.

Env knobs: VDF_PROBE_WINDOWED=1 (sliding-window state), VDF_WINDOW_ROWS,
VDF_PROBE_PLANT, VDF_SWEEP_DEBUG=1, plus the kernel geometry knobs
(VDF_TILE_M / VDF_TILE_N / VDF_BAND_TILES / VDF_SWEEP_CALLS).

Usage: [env knobs] python tools/probe_sweep.py [N] [iters]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vid_dup_finder_lib_tpu.utils.jaxconfig import (  # noqa: E402
    enable_compilation_cache,
)

CLUSTER_SIZE = 3
CLUSTER_RADIUS = 60  # pairwise <= 120 << 350


def main() -> None:
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    plant = int(os.environ.get("VDF_PROBE_PLANT", "0"))

    rng = np.random.default_rng(0)
    durations = np.sort(rng.integers(30, 7200, n))

    # planted clusters: cluster members share the seed row's duration
    starts = np.array([], dtype=np.int64)
    if plant:
        starts = np.sort(rng.choice(n // 8 - 1, plant, replace=False) * 8)
        for s in starts:
            durations[s : s + CLUSTER_SIZE] = durations[s]

    bounds = np.searchsorted(
        durations, (durations.astype(np.float64) * 1.1).astype(np.int64),
        side="right",
    )
    comps = int(np.sum(np.maximum(bounds - np.arange(1, n + 1), 0)))

    n_row_tiles = -(-n // hp.TILE_M)
    n_row_chunks = -(-n_row_tiles // hp.R_TILES)
    n_pad = (
        n_row_chunks * hp.R_TILES * hp.TILE_M
        + (hp.BAND_TILES + 1) * hp.TILE_N
    )
    t0 = time.time()

    # one fused jit (mask via broadcast &, not .at copies) and a DONATED
    # scatter: at 4M+ the extra whole-library copies of the naive version
    # stacked on top of the +/-1 matrix and OOM'd the 16 GB HBM
    import functools

    @jax.jit
    def gen(key):
        p = jax.random.bits(key, (n_pad, 32), dtype=jnp.uint32)
        mask = jnp.concatenate(
            [
                jnp.full((31,), 0xFFFFFFFF, jnp.uint32),
                jnp.full((1,), 0xFF, jnp.uint32),
            ]
        )
        return p & mask[None, :]

    packed_dev = gen(jax.random.key(0))

    if plant:
        # fetch the seed rows (one small d2h), build noisy copies on host,
        # scatter them back in place (donated buffer)
        seeds = np.asarray(
            jnp.take(packed_dev, jnp.asarray(starts), axis=0)
        )
        rows = []
        idxs = []
        for si, s in enumerate(starts):
            for k in range(1, CLUSTER_SIZE):
                h = seeds[si].copy()
                for b in rng.choice(1000, CLUSTER_RADIUS, replace=False):
                    h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
                rows.append(h)
                idxs.append(s + k)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def scatter(p, idx, new_rows):
            return p.at[idx].set(new_rows)

        packed_dev = scatter(
            packed_dev,
            jnp.asarray(np.array(idxs)),
            jnp.asarray(np.stack(rows)),
        )
    packed_dev.block_until_ready()
    # force completion with a d2h fetch before timing
    int(np.asarray(packed_dev[0, 0]))
    print(f"# device library gen: {time.time() - t0:.3f}s")

    t0 = time.time()
    if os.environ.get("VDF_PROBE_WINDOWED") == "1":
        wr = int(os.environ.get("VDF_WINDOW_ROWS", "0")) or None
        state = hp.WindowedPallasState(
            None, bounds, n=n, packed_dev=packed_dev, window_rows=wr
        )
        print(
            f"# windowed: window_rows={state.window_rows} "
            f"({state.window_rows / 2**20:.2f} GB int8 resident)"
        )
    else:
        state = hp.PallasSearchState(None, bounds, n=n, packed_dev=packed_dev)
        state.pm1.block_until_ready()
        int(np.asarray(state.pm1[0, 0]))  # force completion
    print(f"# state build: {time.time() - t0:.3f}s")
    print(
        f"# n={n} comps={comps:.4g} TILE_M={hp.TILE_M} TILE_N={hp.TILE_N} "
        f"BAND_TILES={hp.BAND_TILES} SWEEP_CALLS={hp.SWEEP_CALLS} "
        f"PM_DTYPE={hp.PM_DTYPE} plant={plant}"
    )
    for it in range(iters):
        t0 = time.time()
        ii, jj = hp.banded_adjacency_pallas(None, bounds, 350, state=state)
        dt = time.time() - t0
        print(
            f"iter{it}: {dt:.3f}s rate={comps / dt:.4g} comps/s "
            f"pairs={len(ii)}"
        )

    if plant:
        pair_set = set(zip(ii.tolist(), jj.tolist()))
        missing = 0
        for s in starts:
            for a in range(s, s + CLUSTER_SIZE):
                for b in range(a + 1, s + CLUSTER_SIZE):
                    if (a, b) not in pair_set:
                        missing += 1
        assert missing == 0, f"{missing} planted pairs missed"
        print(f"# planted-pair check OK ({plant} clusters)")


if __name__ == "__main__":
    main()
