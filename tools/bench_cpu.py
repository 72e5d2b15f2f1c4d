"""CPU-backend benchmark evidence: the no-accelerator story.

Measures, at VDF_CPU_N (default 100k) hashes with planted clusters:

* the native C++ sweep (production CPU fallback; AVX-512 VPOPCNTDQ
  4-wide path where the host supports it) at 1 thread and all threads,
* the scalar reference-equivalent probe rate (``vdf_count_leq`` — what
  BASELINE.md cites as the stand-in for the reference's Rust loop),
* the blocked-NumPy host sweep,
* the public-API end-to-end auto search (objects -> groups), asserting
  planted-cluster exactness.

Writes one JSON line per measurement to VDF_CPU_OUT (default
``build/bench_cpu.jsonl``, not committed).
Forces the CPU platform; safe to run anywhere.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

from bench import (  # noqa: E402
    CLUSTER_SIZE,
    N_CLUSTERS,
    TOLERANCE_INT,
    self_search_bounds,
    synth_library,
)


def main() -> None:
    n = int(os.environ.get("VDF_CPU_N", "100000"))
    out_path = os.environ.get(
        "VDF_CPU_OUT", os.path.join(_REPO, "build", "bench_cpu.jsonl")
    )
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    packed, durations, starts = synth_library(n)
    bounds = self_search_bounds(durations)
    comps = int(np.sum(np.maximum(bounds - np.arange(1, n + 1), 0)))
    lines: list[dict] = []

    def emit(metric: str, secs: float, **extra) -> None:
        line = {
            "metric": metric,
            "value": round(comps / secs, 1),
            "unit": "comparisons/s",
            "secs": round(secs, 3),
            "comps": comps,
            "n": n,
            **extra,
        }
        lines.append(line)
        print(json.dumps(line))

    def check_pairs(ii, jj) -> None:
        got = set(zip(ii.tolist(), jj.tolist()))
        for s in starts:
            for a in range(s, s + CLUSTER_SIZE):
                for b in range(a + 1, s + CLUSTER_SIZE):
                    assert (a, b) in got, (a, b)

    from vid_dup_finder_lib_tpu.native import (
        available,
        banded_adjacency_native,
        count_leq_native,
    )

    packed64 = np.ascontiguousarray(packed).view(np.uint64)
    if available():
        for threads, tag in ((1, "1thread"), (0, "allthreads")):
            t0 = time.time()
            ii, jj = banded_adjacency_native(
                packed64, bounds, TOLERANCE_INT, n_threads=threads
            )
            emit(f"cpu_native_{tag}", time.time() - t0, pairs=len(ii))
            check_pairs(ii, jj)
        t0 = time.time()
        count_leq_native(packed64, bounds, TOLERANCE_INT, n_threads=1)
        emit(
            "cpu_scalar_reference_equiv_probe",
            time.time() - t0,
            note="vdf_count_leq stays scalar per-word popcount on "
            "purpose - the reference-shaped baseline",
        )

    if comps <= 2_000_000_000:  # the NumPy sweep runs ~3.5e6 comps/s
        from vid_dup_finder_lib_tpu.ops.hamming import (
            banded_adjacency_host,
        )

        t0 = time.time()
        ii, jj = banded_adjacency_host(packed, bounds, TOLERANCE_INT)
        emit("cpu_host_numpy", time.time() - t0, pairs=len(ii))
        check_pairs(ii, jj)

    # public-API e2e (objects -> groups) on the auto backend
    from vid_dup_finder_lib_tpu.search import Search
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    hashes = [
        VideoHash.from_packed_u32(
            packed[i], f"/v/{i:08}.mp4", int(durations[i])
        )
        for i in range(n)
    ]
    s = Search(hashes)
    t0 = time.time()
    groups = s.search_self(0.35, backend="auto")
    e2e = time.time() - t0
    by_first = {min(g): sorted(g) for g in groups}
    ok = sum(
        1
        for st in starts
        if by_first.get(f"/v/{st:08}.mp4")
        == sorted(f"/v/{i:08}.mp4" for i in range(st, st + CLUSTER_SIZE))
    )
    assert ok == N_CLUSTERS, f"{ok}/{N_CLUSTERS} planted clusters"
    emit(
        "cpu_e2e_auto_search",
        e2e,
        groups=len(groups),
        planted_clusters_ok=ok,
    )

    # batched multi-reference search (CPU native windowed sweep)
    r = int(os.environ.get("VDF_CPU_REFS", "500"))
    refs = [
        VideoHash.from_packed_u32(
            packed[int(i)], f"/r/{k}.mp4", int(durations[int(i)])
        )
        for k, i in enumerate(
            np.random.default_rng(9).integers(0, n, r)
        )
    ]
    s.matched[:] = False  # search_self above marked every entry visited
    s.search_with_references_batched(refs[:8], 0.35)  # warm
    t0 = time.time()
    res = s.search_with_references_batched(refs, 0.35)
    dt = time.time() - t0
    windows = [s._duration_slice(x.duration) for x in refs]
    ref_comps = int(sum(w[1] - w[0] for w in windows))
    matches = sum(len(x) for x in res)
    line = {
        "metric": f"cpu_refs_batched@{r}x{n}",
        "value": round(ref_comps / dt, 1),
        "unit": "comparisons/s",
        "secs": round(dt, 3),
        "comps": ref_comps,
        "matches": matches,
    }
    lines.append(line)
    print(json.dumps(line))
    assert matches >= r  # every ref's own row is within tolerance 0

    with open(out_path, "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    print(f"# wrote {out_path}", file=sys.stderr)


if __name__ == "__main__":
    main()
