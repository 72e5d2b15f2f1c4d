"""Scale-point bench runner for the windowed sweep states.

Runs the two-phase banded sweep at each N in VDF_SCALE_NS (default
1M/4M/8M/16M) with a device-born library and 200 planted duplicate
clusters, each N in its OWN subprocess (a fresh process per point keeps
the measurements independent; the parent never imports JAX, so one
process holds the card at a time), and writes one JSON line per N to the
output file.  The windowed state engages automatically above
``platform.resident_rows()``, exactly as `search(backend="auto")` does.

Usage:
    python tools/bench_scale.py                 # full sweep -> JSON file
    python tools/bench_scale.py --child N       # one point, JSON to stdout
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from vid_dup_finder_lib_tpu.utils.jaxconfig import (  # noqa: E402
    enable_compilation_cache,
)

# VDF_SCALE_CLUSTERS=10000 VDF_SCALE_CLUSTER_SIZE=5 gives the dense-
# duplicate hardware point (round-4 VERDICT item 7): ~1% duplicate rate
# at 1M (10k clusters x C(5,2) = 100k planted pairs) so phase-B
# extraction, the V2 hot-row path and the host greedy replay are
# measured under load on the device, not just on the CPU backend.
CLUSTERS = int(os.environ.get("VDF_SCALE_CLUSTERS", "200"))
CLUSTER_SIZE = int(os.environ.get("VDF_SCALE_CLUSTER_SIZE", "3"))
CLUSTER_RADIUS = 60  # pairwise <= 120 << 350
TOL = 350


def _hbm_peak_gb() -> float | None:
    try:
        import jax

        stats = jax.local_devices()[0].memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        return round(peak / 2**30, 2) if peak else None
    except Exception:
        return None


def run_point(n: int) -> dict:
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(0)
    durations = np.sort(rng.integers(30, 7200, n))
    stride = max(8, CLUSTER_SIZE + 1)
    starts = np.sort(
        rng.choice(n // stride - 1, CLUSTERS, replace=False) * stride
    )
    for s in starts:
        durations[s : s + CLUSTER_SIZE] = durations[s]
    bounds = np.searchsorted(
        durations, (durations.astype(np.float64) * 1.1).astype(np.int64),
        side="right",
    )
    comps = int(np.sum(np.maximum(bounds - np.arange(1, n + 1), 0)))

    windowed_pre = n >= int(
        os.environ.get("VDF_WINDOWED_THRESHOLD", "3000000")
    )
    split = os.environ.get("VDF_SCALE_SPLIT")
    split = (
        split == "1"
        if split is not None
        else (windowed_pre and hp.should_split(n, bounds))
    )
    # size the device-born buffer at the state's exact `need` so the
    # state takes the no-copy path (a pad concatenate transiently
    # doubles an 8.2 GB buffer at 64M — past HBM)
    if split:
        n_pad = hp.split_need(n, bounds)
    elif windowed_pre:
        wr0 = int(os.environ.get("VDF_WINDOW_ROWS", "0")) or None
        n_pad = hp.windowed_need(n, bounds, window_rows=wr0)
    else:
        n_row_tiles = -(-n // hp.TILE_M)
        n_row_chunks = -(-n_row_tiles // hp.R_TILES)
        n_pad = (
            n_row_chunks * hp.R_TILES * hp.TILE_M
            + (hp.BAND_TILES + 1) * hp.TILE_N
        )

    t0 = time.time()
    chunked = n_pad * 128 > hp._max_alloc_bytes()
    if chunked:
        # past the single-allocation watermark: generate the library
        # directly into a ChunkedPackedStore, chunk by chunk.  Chunks
        # are fit to n_pad (equal-size, waste < align rows) unless
        # VDF_CHUNK_ROWS pins them — with the default 16M-row chunks a
        # 100M-hash library would round 101M rows up to 117M, 1.9 GiB
        # of dead HBM exactly where none is spare.
        if os.environ.get("VDF_CHUNK_ROWS"):
            cr = hp._default_chunk_rows()
        else:
            cr = hp.fit_chunk_rows(n_pad)
        total = -(-n_pad // cr) * cr

        @jax.jit
        def gen_chunk(key):
            p = jax.random.bits(key, (cr, 32), dtype=jnp.uint32)
            mask = jnp.concatenate(
                [
                    jnp.full((31,), 0xFFFFFFFF, jnp.uint32),
                    jnp.full((1,), 0xFF, jnp.uint32),
                ]
            )
            return p & mask[None, :]

        packed_dev = hp.ChunkedPackedStore(
            [gen_chunk(jax.random.key(ci)) for ci in range(total // cr)],
            cr,
        )
        seeds = packed_dev.take_rows(starts)
    else:

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
        seeds = np.asarray(
            jnp.take(packed_dev, jnp.asarray(starts), axis=0)
        )
    rows, idxs = [], []
    for si, s in enumerate(starts):
        for k in range(1, CLUSTER_SIZE):
            h = seeds[si].copy()
            for b in rng.choice(1000, CLUSTER_RADIUS, replace=False):
                h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
            rows.append(h)
            idxs.append(s + k)

    import functools

    if chunked:
        # donate: this generator is the sole owner of the fresh store,
        # and a chunk-sized copy would not fit at the capacity edge
        packed_dev.scatter_rows(
            np.array(idxs), np.stack(rows), donate=True
        )
        int(packed_dev.take_rows(np.array([0]))[0, 0])  # force completion
    else:

        @functools.partial(jax.jit, donate_argnums=(0,))
        def scatter(p, idx, new_rows):
            return p.at[idx].set(new_rows)

        packed_dev = scatter(
            packed_dev, jnp.asarray(np.array(idxs)),
            jnp.asarray(np.stack(rows)),
        )
        int(np.asarray(packed_dev[0, 0]))  # force completion
    gen_secs = time.time() - t0

    if os.environ.get("VDF_SCALE_BACKEND") == "ring":
        assert not chunked, (
            "the ring shards one flat packed block per device; past the "
            "single-allocation watermark use the split driver "
            "(ring_capacity_ok vetoes the ring there in backend='auto')"
        )
        # the multi-chip backend on the real chip (degenerate 1-device
        # ring unless more devices exist): compiled Mosaic kernels under
        # shard_map, device-resident packed input, optional row windows
        from vid_dup_finder_lib_tpu.parallel.mesh import make_mesh
        from vid_dup_finder_lib_tpu.parallel.ring_pallas import (
            banded_adjacency_ring,
        )

        mesh = make_mesh()
        wr = int(os.environ.get("VDF_RING_WINDOW_ROWS", "0")) or None
        iters = int(os.environ.get("VDF_SCALE_ITERS", "2"))
        best = None
        for _ in range(iters):
            t0 = time.time()
            ii, jj = banded_adjacency_ring(
                packed_dev[:n], bounds, TOL, mesh=mesh,
                window_rows=wr,
            )
            dt = time.time() - t0
            best = dt if best is None else min(best, dt)
        pair_set = set(zip(ii.tolist(), jj.tolist()))
        missing = sum(
            1
            for s in starts
            for a in range(s, s + CLUSTER_SIZE)
            for b in range(a + 1, s + CLUSTER_SIZE)
            if (a, b) not in pair_set
        )
        assert missing == 0, f"{missing} planted pairs missed at n={n}"
        return {
            "metric": f"ring_hamming_comps_per_sec@{n}",
            "value": round(comps / best, 1),
            "unit": "comparisons/s",
            "secs": round(best, 3),
            "comps": comps,
            "n_devices": int(mesh.devices.size),
            "window_rows": wr,
            "pipelined": os.environ.get("VDF_RING_PIPELINE", "0") == "1",
            "pairs": len(ii),
            "planted_clusters_ok": CLUSTERS,
            "cluster_size": CLUSTER_SIZE,
            "gen_secs_untimed": round(gen_secs, 2),
            "tile": [hp.TILE_M, hp.TILE_N, hp.BAND_TILES],
            "hbm_peak_gb": _hbm_peak_gb(),
            "phases": {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in __import__(
                    "vid_dup_finder_lib_tpu.parallel.ring_pallas",
                    fromlist=["LAST_RING_PHASES"],
                ).LAST_RING_PHASES.items()
            },
        }

    windowed = windowed_pre
    t0 = time.time()
    if split:
        state = hp.SplitWindowState(
            None, bounds, n=n, packed_dev=packed_dev
        )
    elif windowed:
        wr = int(os.environ.get("VDF_WINDOW_ROWS", "0")) or None
        state = hp.WindowedPallasState(
            None, bounds, n=n, packed_dev=packed_dev, window_rows=wr
        )
    else:
        state = hp.PallasSearchState(None, bounds, n=n, packed_dev=packed_dev)
        state.pm1.block_until_ready()
        int(np.asarray(state.pm1[0, 0]))
    state_secs = time.time() - t0

    iters = int(os.environ.get("VDF_SCALE_ITERS", "2"))
    best = None
    for _ in range(iters):
        t0 = time.time()
        ii, jj = hp.banded_adjacency_pallas(None, bounds, TOL, state=state)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)

    pair_set = set(zip(ii.tolist(), jj.tolist()))
    missing = sum(
        1
        for s in starts
        for a in range(s, s + CLUSTER_SIZE)
        for b in range(a + 1, s + CLUSTER_SIZE)
        if (a, b) not in pair_set
    )
    assert missing == 0, f"{missing} planted pairs missed at n={n}"

    phases = {
        k: (round(v, 3) if isinstance(v, float) else v)
        for k, v in hp.LAST_SWEEP_PHASES.items()
    }
    return {
        "metric": f"hamming_comps_per_sec@{n}",
        "value": round(comps / best, 1),
        "unit": "comparisons/s",
        "secs": round(best, 3),
        "comps": comps,
        "windowed": windowed,
        "split": split,
        "split_windows": (
            [state.rows_window_rows, state.window_rows] if split else None
        ),
        "split_rebuilds": (
            [state.rebuilds_rows, state.rebuilds] if split else None
        ),
        "pairs": len(ii),
        "planted_clusters_ok": CLUSTERS,
        "cluster_size": CLUSTER_SIZE,
        "gen_secs_untimed": round(gen_secs, 2),
        "state_secs_untimed": round(state_secs, 2),
        "tile": [hp.TILE_M, hp.TILE_N, hp.BAND_TILES],
        "pm_dtype": hp.PM_DTYPE,
        "launch": hp.sweep_launch(),
        "phase_b_per_tile": (
            os.environ.get("VDF_PHASE_B_PER_TILE", "1") == "1"
            and hp.R_TILES == 1
        ),  # mirrors the driver's effective default
        "hbm_peak_gb": _hbm_peak_gb(),
        # also report the planned steady-state footprint so capacity
        # lines are self-describing
        "est_footprint_gb": round(
            (
                getattr(
                    getattr(state, "packed_dev", None), "nbytes", 0
                )
                + (
                    (state.rows_window_rows + state.window_rows)
                    if split
                    else getattr(state, "window_rows", 0)
                )
                * (1024 if hp.PM_DTYPE == "int8" else 2048)
                + (
                    state._bounds_full.nbytes
                    if hasattr(state, "_bounds_full")
                    else 0
                )
            )
            / 2**30,
            2,
        ),
        "packed_chunks": (
            len(state.packed_dev.chunks)
            if hasattr(getattr(state, "packed_dev", None), "chunks")
            else None
        ),
        "phases": phases,
    }


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        print(json.dumps(run_point(int(sys.argv[2]))), flush=True)
        return

    ns = [
        int(x)
        for x in os.environ.get(
            "VDF_SCALE_NS", "1000000,4000000,8000000,16000000"
        ).split(",")
    ]
    out_path = os.environ.get(
        "VDF_SCALE_OUT", os.path.join(_REPO, "chiprun_out", "scale.jsonl")
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = []
    for n in ns:
        print(f"# scale point n={n} ...", file=sys.stderr, flush=True)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(n)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            print(proc.stderr[-2000:], file=sys.stderr)
            raise RuntimeError(f"scale point n={n} failed")
        line = proc.stdout.strip().splitlines()[-1]
        results.append(json.loads(line))
        print(line, flush=True)
        with open(out_path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in results) + "\n")
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
