"""Production-scale API walkthrough (synthetic hashes, no video files).

Demonstrates the device-resident library lifecycle that a large
deployment uses — the surfaces that go beyond the reference crate's API
(the reference is single-node CPU; SURVEY.md section 2.7):

1. ``IncrementalDeviceLibrary``: append packed hashes device-side as
   cache updates produce them (only new rows ride host-to-device).
2. ``library.state(...)`` + ``banded_adjacency_pallas``: repeated
   duplicate sweeps against the resident library (tolerance sweeps pay
   only kernel time, never re-upload).
3. ``search_with_references(..., device_library=)``: multi-reference
   search against the same resident rows.
4. ``search(backend="ring")``: the multi-chip path — shards the library
   over every visible device (ppermute ring of packed blocks); on one
   device it degenerates to a single shard and still returns the exact
   groups.

Runs on the CPU backend or a CUDA GPU alike:

    python examples/example_scale.py [n_hashes]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import vid_dup_finder_lib_tpu as vdf  # noqa: E402
from vid_dup_finder_lib_tpu.ops.hamming_pallas import (  # noqa: E402
    IncrementalDeviceLibrary,
    banded_adjacency_pallas,
)
from vid_dup_finder_lib_tpu.video_hash import (  # noqa: E402
    VideoHash,
    hashes_to_matrix,
)


def synth_hashes(n: int, seed: int = 0) -> list[VideoHash]:
    """Random library with planted duplicate pairs at indices (8k, 8k+1)."""
    rng = np.random.default_rng(seed)
    hashes = [
        VideoHash.random_hash(rng)
        .with_src_path(f"/videos/{i:06}.mp4")
        .with_duration(int(d))
        for i, d in enumerate(np.sort(rng.integers(30, 7200, n)))
    ]
    for k in range(0, n - 1, n // 8):
        hashes[k + 1] = (
            hashes[k]
            .hash_with_spatial_distance(80, rng)
            .with_src_path(hashes[k + 1].src_path)
            .with_duration(hashes[k].duration)
        )
    return hashes


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    hashes = synth_hashes(n)

    # -- 1. append-only device-resident library (cache-update flow) ----
    lib = IncrementalDeviceLibrary(capacity=1024)
    insertion_paths = [h.src_path for h in hashes]
    for a in range(0, n, 1024):  # batches, as a cache update produces them
        lib.append(hashes_to_matrix(hashes[a : a + 1024]))

    # -- 2. repeated sweeps against the resident rows ------------------
    durs = np.array(sorted(h.duration for h in hashes), np.int64)
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), "right")
    state = lib.state(np.argsort(durs, kind="stable"), bounds)
    for tol in (300, 350):
        pi, pj = banded_adjacency_pallas(None, bounds, tol, state=state)
        print(f"tolerance {tol}: {len(pi)} in-band duplicate pairs")

    # -- 3. the public API end-to-end ----------------------------------
    groups = vdf.search(hashes, 0.35)
    print(f"search(): {len(groups)} duplicate groups")
    assert len(groups) >= 7

    refs = [
        hashes[5].with_src_path("/refs/a"),
        hashes[n // 2].with_src_path("/refs/b"),
    ]
    ref_groups = vdf.search_with_references(
        refs, hashes, 0.35,
        device_library=lib, library_paths=insertion_paths,
    )
    print(f"search_with_references(resident): {len(ref_groups)} groups")
    assert len(ref_groups) == 2

    # -- 4. the multi-chip backend (exact on any mesh size) ------------
    ring_groups = vdf.search(hashes, 0.35, backend="ring")
    assert [list(g.contained_paths()) for g in ring_groups] == [
        list(g.contained_paths()) for g in groups
    ]
    print(f"search(backend='ring'): identical {len(ring_groups)} groups")
    print("OK")


if __name__ == "__main__":
    main()
