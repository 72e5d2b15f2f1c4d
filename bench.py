"""Headline benchmark: all-pairs Hamming dedup over a 1M-hash library.

Runs the duration-banded XOR-popcount-equivalent search (the two-phase
int8 +/-1 sweep on the GPU) over a synthetic library with planted
duplicate clusters, verifies the planted duplicates are found, and reports
comparisons/second.  It needs a CUDA GPU and exits non-zero without one.

Baseline: the reference (vid_dup_finder_lib) performs the same banded sweep
as a scalar XOR+POPCNT loop on CPU (search_algorithm.rs:131-170,
video_hash.rs:311-317).  It publishes no numbers (BASELINE.md), so the
baseline is self-measured here: the same banded comparison work done with
NumPy's vectorized popcount on this machine's CPU — a generous stand-in for
the reference's single-threaded Rust loop (measured on a subsample and
extrapolated).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...,
"device": {"platform", "device_kind", "count"}}.

Env knobs: VDF_BENCH_N (library size, default 1_000_000),
VDF_BENCH_BACKEND (pallas|device|native|host, default auto),
VDF_SWEEP_DEBUG=1 (sweep phase breakdown to stderr).  Larger-N scale
points (device-born library, sliding-window operands) come from
``tools/probe_sweep.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from vid_dup_finder_lib_tpu.definitions import HASH_WORDS32  # noqa: E402
from vid_dup_finder_lib_tpu.utils.jaxconfig import (  # noqa: E402
    enable_compilation_cache,
)

TOLERANCE_INT = 350  # default-ish tolerance in integer Hamming domain
N_CLUSTERS = 200
CLUSTER_SIZE = 3
CLUSTER_RADIUS = 60  # bit flips from the cluster seed; pairwise <= 120 < 350


def synth_library(n: int, seed: int = 0):
    """Random hash library, sorted by duration, with planted dup clusters.

    Returns (packed uint32[n, 32], durations int64[n], planted pair count).
    """
    rng = np.random.default_rng(seed)
    packed = rng.integers(
        0, 2**32, (n, HASH_WORDS32), dtype=np.uint64
    ).astype(np.uint32)
    # mask the 24 pad bits of the last word so distances stay in 0..1000
    packed[:, -1] &= np.uint32(0x000000FF)
    durations = np.sort(rng.integers(30, 7200, n))

    # plant clusters: overwrite CLUSTER_SIZE consecutive rows with noisy
    # copies of a seed hash (consecutive rows share a duration window)
    # grid-spaced starts so cluster ranges can never overlap
    starts = rng.choice(n // 8 - 1, N_CLUSTERS, replace=False) * 8
    for s in starts:
        seed_hash = packed[s].copy()
        for k in range(1, CLUSTER_SIZE):
            h = seed_hash.copy()
            flips = rng.choice(1000, CLUSTER_RADIUS, replace=False)
            for f in flips:
                h[f // 32] ^= np.uint32(1) << np.uint32(f % 32)
            packed[s + k] = h
            # pulling intermediate durations down to durations[s] keeps the
            # array sorted (following entries were already >= durations[s])
            durations[s + k] = durations[s]
    assert np.all(np.diff(durations) >= 0)
    return packed, durations, starts


def self_search_bounds(durations: np.ndarray) -> np.ndarray:
    thresh = (durations.astype(np.float64) * 1.1).astype(np.int64)
    return np.searchsorted(durations, thresh, side="right")


def cpu_baseline_rate(packed, bounds, sample_rows: int = 4096) -> float:
    """Reference-equivalent CPU loop over a sample of the same banded work.

    Prefers the native C++ XOR+POPCNT sweep (single thread — the reference's
    search is single-threaded); falls back to NumPy popcount."""
    n = packed.shape[0]
    r0 = n // 3
    r1 = min(r0 + sample_rows, n)
    sub = packed[r0 : int(bounds[r0:r1].max())]
    sub_bounds = np.maximum(bounds[r0:r1] - r0, 0)[: sub.shape[0]]
    sub_bounds = np.concatenate(
        [sub_bounds, np.zeros(max(0, sub.shape[0] - sub_bounds.size), np.int64)]
    )
    comps = int(np.sum(np.maximum(sub_bounds - np.arange(1, sub.shape[0] + 1), 0)))
    if comps <= 0:
        return 1.0
    try:
        from vid_dup_finder_lib_tpu.native import (
            available,
            count_leq_native,
        )

        if available():
            packed64 = np.ascontiguousarray(sub).view(np.uint64)
            t = time.time()
            count_leq_native(packed64, sub_bounds, TOLERANCE_INT, n_threads=1)
            return comps / (time.time() - t)
    except Exception:
        pass
    t = time.time()
    block = 256
    for rs in range(0, sub.shape[0], block):
        re_ = min(rs + block, sub.shape[0])
        ce = int(sub_bounds[rs:re_].max())
        if ce <= rs + 1:
            continue
        d = np.bitwise_count(
            sub[rs:re_, None, :] ^ sub[None, rs + 1 : ce, :]
        ).sum(axis=2)
        (d <= TOLERANCE_INT).sum()
    return comps / (time.time() - t)


def main() -> None:
    import jax

    from vid_dup_finder_lib_tpu import platform

    if platform.backend() != "gpu":
        # a measurement path never falls back to the CPU
        print(
            f"bench.py needs a CUDA GPU; JAX found {jax.default_backend()!r}",
            file=sys.stderr,
        )
        sys.exit(2)
    enable_compilation_cache()
    n = int(os.environ.get("VDF_BENCH_N", "1000000"))
    backend = os.environ.get("VDF_BENCH_BACKEND", "auto")
    dev = jax.devices()[0]

    packed, durations, starts = synth_library(n)
    bounds = self_search_bounds(durations)
    comps = int(np.sum(np.maximum(bounds - np.arange(1, n + 1), 0)))
    samples: list[float] | None = None

    from vid_dup_finder_lib_tpu.ops.hamming import (
        banded_adjacency_device,
        banded_adjacency_host,
    )

    use_pallas = backend in ("auto", "pallas")

    if use_pallas:
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            PallasSearchState,
            banded_adjacency_pallas,
        )

        # warm-up on a slice to trigger (cached) compilation
        warm_n = min(4096, n)
        banded_adjacency_pallas(
            packed[:warm_n],
            np.minimum(bounds[:warm_n], warm_n),
            TOLERANCE_INT,
        )

        # COLD: streamed build — chunked h2d of the library overlaps
        # the banded sweep (the near-diagonal band lets early rows sweep
        # while later rows upload).  This is what a cold search over a
        # host-resident library costs, compile caches warm.
        t0 = time.time()
        state = PallasSearchState(packed, bounds, defer_upload=True)
        ii, jj = banded_adjacency_pallas(
            packed, bounds, TOLERANCE_INT, state=state
        )
        cold_secs = time.time() - t0
        # RESIDENT: the library is now device-resident, so a re-search
        # pays only the sweep; the headline is the MEDIAN of several
        # sweeps with the spread reported.
        iters = int(os.environ.get("VDF_BENCH_ITERS", "3"))
        samples = []
        for _ in range(iters):
            t0 = time.time()
            ii, jj = banded_adjacency_pallas(
                packed, bounds, TOLERANCE_INT, state=state
            )
            samples.append(time.time() - t0)
        dt = float(np.median(samples))
    else:
        if backend == "host":

            def run():
                return banded_adjacency_host(packed, bounds, TOLERANCE_INT)

        elif backend == "native":
            from vid_dup_finder_lib_tpu.native import (
                banded_adjacency_native,
            )

            packed64 = np.ascontiguousarray(packed).view(np.uint64)

            def run():
                return banded_adjacency_native(
                    packed64, bounds, TOLERANCE_INT
                )

        else:

            def run():
                return banded_adjacency_device(
                    packed, bounds, TOLERANCE_INT
                )

        run()  # warm: first-time executable builds for this size bucket
        t0 = time.time()
        ii, jj = run()
        cold_secs = dt = time.time() - t0

    # sanity: every planted cluster must be recovered in the pair set
    pair_set = set(zip(ii.tolist(), jj.tolist()))
    missing = 0
    for s in starts:
        for a in range(s, s + CLUSTER_SIZE):
            for b in range(a + 1, s + CLUSTER_SIZE):
                if (a, b) not in pair_set:
                    missing += 1
    assert missing == 0, f"{missing} planted pairs missed"

    samples = samples or [dt]
    phases = {}
    if use_pallas:
        from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

        phases = {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in hp.LAST_SWEEP_PHASES.items()
        }

    base_rate = cpu_baseline_rate(packed, bounds)
    rate_resident = comps / dt
    # Two numbers: "resident" = sweep over the device-resident library
    # (the steady state of repeated searches), and "cold" = end to end
    # including the library upload streamed beside the sweep.
    rate_cold = comps / cold_secs

    print(
        json.dumps(
            {
                "metric": f"hamming_comps_per_sec@{n}",
                "value": round(rate_resident, 1),
                "unit": "comparisons/s",
                "vs_baseline": round(rate_resident / base_rate, 2),
                "cold_rate": round(rate_cold, 1),
                "cold_secs": round(cold_secs, 3),
                "resident_sweep_secs": round(dt, 3),
                "resident_samples_secs": [round(s, 3) for s in samples],
                "resident_spread_secs": round(
                    max(samples) - min(samples), 3
                ),
                "phases": phases,
                "device": {
                    "platform": dev.platform,
                    "device_kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    print(
        f"# n={n} comps={comps:.4g} cold={cold_secs:.2f}s "
        f"resident_sweep={dt:.2f}s pairs={len(ii)} "
        f"cpu_baseline={base_rate:.4g}/s backend={backend}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
