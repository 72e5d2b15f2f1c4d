"""Multi-reference search throughput: R references against N candidates.

The reference loops refs one at a time against a binary-searched
duration slice (video_dup_finder.rs:19-46) — scalar XOR+POPCNT per pair.
Here large workloads ride the device as the two-phase int8 sweep over
the per-ref [0.95d, 1.05d] windows.

Round-4 kernels (VDF_REFS_KERNEL):
* ``windowed`` (default on a GPU) — ``refs_adjacency_windowed``: refs rows
  resident, sliding +/-1 COLUMN window over the device-resident packed
  candidates; scales past +/-1 HBM capacity (16M+ cands) and bucketed
  jit shapes kill the per-(r, n) first-call specialization.
* ``combined`` — the round-3 [cands | refs] resident path
  (``refs_adjacency_pallas``), kept as a comparison point.

Knobs: VDF_REFS_R / VDF_REFS_N; VDF_REFS_DEVGEN=1 generates the
candidate library ON DEVICE (no 128 B/hash h2d — default above 4M);
VDF_REFS_WINDOW_ROWS sizes the column window.

VDF_REFS_KERNEL=public (round-5 item 6) measures the PUBLIC function
instead of the ops layer: ``search_with_references`` — VideoHash
objects in, MatchGroups out, candidates attached as a device-resident
``IncrementalDeviceLibrary`` (rows appended pre-sorted; one-time append
untimed) — so the number includes Search construction, the per-ref
window plumbing, ``matched`` filtering and group assembly
(video_dup_finder.rs:19-46's full surface).

Usage: python tools/bench_refs.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vid_dup_finder_lib_tpu.utils.jaxconfig import (  # noqa: E402
    enable_compilation_cache,
)


def _run_public(
    r, n, rng, refs, cands, cands_dev, cand_durs, ref_durs,
    lo, hi, planted, comps, gen_secs, upload_secs,
) -> None:
    """PUBLIC-function refs benchmark: search_with_references with an
    attached device-resident candidate library (round-5 item 6)."""
    import jax
    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        IncrementalDeviceLibrary,
    )
    from vid_dup_finder_lib_tpu.search import search_with_references
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    tol = 350 / 1000.0

    # host objects for BOTH sides (what a user holds).  Candidate rows
    # must exist on host for object construction: fetch the device-born
    # library d2h once (untimed), or use the host-generated rows.
    fetch_secs = None
    if cands is None:
        t0 = time.time()
        cands = np.asarray(cands_dev)
        fetch_secs = time.time() - t0
    t0 = time.time()
    cand_hashes = VideoHash.many_from_packed_u32(
        cands, (f"/v/{i:08}.mp4" for i in range(n)), cand_durs
    )
    ref_hashes = VideoHash.many_from_packed_u32(
        refs, (f"/r/{k:06}.mp4" for k in range(r)), ref_durs
    )
    obj_secs = time.time() - t0

    # device-resident candidate library, appended in sorted order
    # (cand rows ARE duration-sorted and paths ascend with the index)
    t0 = time.time()
    if cands_dev is not None:
        # device-born rows: adopt without h2d (mirror of lib.append).
        # capacity=1024 so the ctor does NOT materialize a dead n-row
        # zeros store (2+ GiB at 16M) that the rebind discards
        lib = IncrementalDeviceLibrary(capacity=1024)
        if n < 1024:
            pad = jnp.zeros((1024 - n, 32), jnp.uint32)
            lib._packed = jnp.concatenate([cands_dev, pad])
            lib._cap = 1024
        else:
            lib._packed = cands_dev
            lib._cap = int(cands_dev.shape[0])
        lib.n = n
    else:
        lib = IncrementalDeviceLibrary(capacity=max(1024, n))
        lib.append(cands)
    # force completion with a d2h fetch before the timed phases
    if hasattr(lib._packed, "take_rows"):
        int(lib._packed.take_rows(np.array([0]))[0, 0])
    else:
        int(np.asarray(lib._packed[0, 0]))
    append_secs = time.time() - t0

    # first call pays Search construction caches + jit buckets; the
    # steady state (fresh Search each time, same objects) is call 2+
    def run():
        return search_with_references(
            ref_hashes, cand_hashes, tol, device_library=lib,
            library_paths=None,
        )

    t0 = time.time()
    groups = run()
    first_secs = time.time() - t0
    t0 = time.time()
    groups = run()
    dt = time.time() - t0

    # planted (ref k, cand idx) pairs must surface as MatchGroups
    by_ref = {g.reference: set(g.duplicates) for g in groups}
    missing = 0
    for k, ci in planted:
        dups = by_ref.get(f"/r/{k:06}.mp4", set())
        if f"/v/{ci:08}.mp4" not in dups:
            missing += 1
    assert missing == 0, f"{missing}/{len(planted)} planted refs missed"

    print(
        json.dumps(
            {
                "metric": f"refs_search_comps_per_sec@{r}x{n}_public",
                "value": round(comps / dt, 1),
                "unit": "comparisons/s (search_with_references,"
                " objects->MatchGroups)",
                "secs": round(dt, 2),
                "first_call_secs_incl_compiles": round(first_secs, 2),
                "groups": len(groups),
                "planted_ok": len(planted),
                "gen_secs_untimed": gen_secs and round(gen_secs, 2),
                "fetch_secs_untimed": fetch_secs and round(fetch_secs, 2),
                "obj_build_secs_untimed": round(obj_secs, 2),
                "lib_adopt_secs_untimed": round(append_secs, 2),
            }
        )
    )


def main() -> None:
    enable_compilation_cache()
    r = int(os.environ.get("VDF_REFS_R", "10000"))
    n = int(os.environ.get("VDF_REFS_N", "1000000"))
    rng = np.random.default_rng(0)

    from vid_dup_finder_lib_tpu import platform

    on_gpu = platform.device_sweep()

    cand_durs = np.sort(rng.integers(30, 7200, n))
    ref_durs = np.sort(rng.integers(30, 7200, r))
    lo = np.searchsorted(cand_durs, (ref_durs * 0.95).astype(np.int64), "left")
    hi = np.searchsorted(cand_durs, (ref_durs * 1.05).astype(np.int64), "right")
    comps = int(np.sum(hi - lo))
    refs = rng.integers(0, 2**32, (r, 32), dtype=np.uint64).astype(np.uint32)

    devgen = (
        os.environ.get("VDF_REFS_DEVGEN", "1" if n > 4_000_000 else "0")
        == "1"
    )
    upload_secs = None
    cands = cands_dev = None
    if devgen and on_gpu:
        # device-born candidate library (no h2d; mirrors bench_scale)
        import jax.numpy as jnp

        t0 = time.time()

        @jax.jit
        def gen(key):
            p = jax.random.bits(key, (n, 32), dtype=jnp.uint32)
            mask = jnp.concatenate(
                [
                    jnp.full((31,), 0xFFFFFFFF, jnp.uint32),
                    jnp.full((1,), 0xFF, jnp.uint32),
                ]
            )
            return p & mask[None, :]

        cands_dev = gen(jax.random.key(0))
        int(np.asarray(cands_dev[0, 0]))  # force completion
        gen_secs = time.time() - t0
    else:
        gen_secs = None
        cands = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
            np.uint32
        )

    # plant matches: every 100th ref copies a candidate INSIDE its own
    # duration window, so recovered pairs validate the sweep exactly
    planted: list[tuple[int, int]] = []
    plant_ks = [k for k in range(0, r, 100) if hi[k] > lo[k]]
    if cands_dev is not None:
        import jax.numpy as jnp

        idx = np.array([int(lo[k]) for k in plant_ks], np.int32)
        rows = np.asarray(jnp.take(cands_dev, jnp.asarray(idx), axis=0))
        for k, row in zip(plant_ks, rows):
            refs[k] = row
            planted.append((k, int(lo[k])))
    else:
        for k in plant_ks:
            refs[k] = cands[int(lo[k])]
            planted.append((k, int(lo[k])))

    tol = 350
    mode = os.environ.get(
        "VDF_REFS_KERNEL", "windowed" if on_gpu else "xla"
    )
    if mode == "public":
        _run_public(
            r, n, rng, refs, cands, cands_dev, cand_durs, ref_durs,
            lo, hi, planted, comps, gen_secs, upload_secs,
        )
        return
    if mode == "windowed":
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            refs_adjacency_windowed,
        )

        wr = int(os.environ.get("VDF_REFS_WINDOW_ROWS", "0")) or None
        if cands_dev is None and on_gpu:
            import jax.numpy as jnp

            t0 = time.time()
            cands_dev = jnp.asarray(cands)
            int(np.asarray(cands_dev[-1, -1]))
            upload_secs = time.time() - t0

        def run():
            return refs_adjacency_windowed(
                refs, lo, hi, tol,
                cands_packed=cands if cands_dev is None else None,
                cands_dev=cands_dev,
                n_cands=n if cands_dev is not None else None,
                window_rows=wr,
            )

    elif mode == "combined":
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            refs_adjacency_pallas,
        )

        if cands_dev is None:
            import jax.numpy as jnp

            t0 = time.time()
            cands_dev = jnp.asarray(cands)
            int(np.asarray(cands_dev[-1, -1]))
            upload_secs = time.time() - t0

        def run():
            return refs_adjacency_pallas(
                refs, None, lo, hi, tol, cands_dev=cands_dev, n_cands=n
            )

    else:
        from vid_dup_finder_lib_tpu.ops.hamming import (
            windowed_adjacency_device,
        )

        def run():
            return windowed_adjacency_device(refs, cands, lo, hi, tol)

    # first call pays any one-time jit work (bucketed shapes for the
    # windowed kernel); the steady state is the second call
    t0 = time.time()
    run()
    first_secs = time.time() - t0
    t0 = time.time()
    pi, pj = run()
    dt = time.time() - t0

    pair_set = set(zip(pi.tolist(), pj.tolist()))
    missing = sum(1 for p in planted if p not in pair_set)
    assert missing == 0, f"{missing}/{len(planted)} planted pairs missed"

    print(
        json.dumps(
            {
                "metric": f"refs_search_comps_per_sec@{r}x{n}_{mode}",
                "value": round(comps / dt, 1),
                "unit": "comparisons/s",
                "secs": round(dt, 2),
                "first_call_secs_incl_compiles": round(first_secs, 2),
                "pairs": int(len(pi)),
                "planted_ok": len(planted),
                "gen_secs_untimed": gen_secs and round(gen_secs, 2),
                "upload_secs_untimed": upload_secs
                and round(upload_secs, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
