"""End-to-end smoke test of hashing and search on one CUDA GPU.

    python chip_smoke.py                  # one card, every phase
    python chip_smoke.py --four-cards     # the multi-device phase only

Runs the main path once through the public entry points, in one process,
with data made from ``--seed``:

1. device: platform, device kind, the card's name and power limit
   (``nvidia-smi``), the memory limit and the compile-cache directory;
2. hashing: seeded raw-frame videos through the device letterbox, Lanczos
   resize and hash, and frame cubes through ``hash_cubes_device``, against
   the f64 golden model;
3. self-search over a 1M-hash library (200 planted clusters of 3) on
   ``auto`` and every device backend, against the native C++ sweep;
4. the same library resident in an ``IncrementalDeviceLibrary``;
5. references search, 10,000 refs against the library, with and without
   the resident library, against the native windowed sweep;
6. each compiled Triton launch against the plain launch on 64 launches of
   the 1M plan, and the whole sweep timed with each launch in turn.

``--four-cards`` runs only the ring self-search and the sharded refs
search at 4M hashes on four devices, each against the one-device result.

Exits non-zero, without the final JSON line, if any phase fails or JAX
finds no GPU.  ``--rehearse-on-cpu`` runs the same control flow at the
sizes given on the CPU backend and always exits 3 without a result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

TOL = 0.35  # search tolerance; 350 in the integer Hamming domain


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi (no JAX here)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e!r})"


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, time.perf_counter() - t0


def group_lists(groups) -> list[tuple]:
    return [(g.reference, tuple(g.duplicates)) for g in groups]


# -- data ---------------------------------------------------------------------


def make_library(n: int, seed: int):
    """The bench library: n random hashes sorted by duration with 200
    planted clusters of 3, as a VideoHashBatch (paths sort with the
    durations, so the search's order is the insertion order)."""
    from bench import CLUSTER_SIZE, synth_library
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    packed, durations, starts = synth_library(n, seed=seed)
    paths = [f"/lib/{i:08d}.mp4" for i in range(n)]
    hashes = VideoHash.many_from_packed_u32(packed, paths, durations)
    planted = [
        [paths[s + k] for k in range(CLUSTER_SIZE)] for s in starts
    ]
    return packed, durations, paths, hashes, planted


def make_refs(packed, durations, n_refs: int, seed: int):
    """n_refs references: every 4th a noisy copy of a library row (at its
    duration), the rest random."""
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    rng = np.random.default_rng(seed + 1)
    n = packed.shape[0]
    refs = rng.integers(0, 2**32, (n_refs, 32), dtype=np.uint64).astype(
        np.uint32
    )
    refs[:, -1] &= np.uint32(0xFF)
    durs = rng.integers(30, 7200, n_refs)
    src = rng.choice(n, n_refs // 4, replace=False)
    for k, s in enumerate(src):
        h = packed[s].copy()
        for f in rng.choice(1000, 100, replace=False):
            h[f // 32] ^= np.uint32(1) << np.uint32(f % 32)
        refs[4 * k] = h
        durs[4 * k] = durations[s]
    paths = [f"/refs/{i:06d}.mp4" for i in range(n_refs)]
    return VideoHash.many_from_packed_u32(refs, paths, durs)


def native_refs_expected(hashes, refs, tol_int: int) -> list[tuple]:
    """search_with_references' groups, computed by the native windowed
    sweep over the same sorted library."""
    from vid_dup_finder_lib_tpu.native import refs_windowed_native
    from vid_dup_finder_lib_tpu.search import Search
    from vid_dup_finder_lib_tpu.video_hash import hashes_to_matrix

    s = Search(hashes)
    order = sorted(range(len(refs)), key=lambda k: refs[k].duration)
    win = [s._duration_slice(refs[k].duration) for k in order]
    lo = np.array([w[0] for w in win], np.int64)
    hi = np.array([w[1] for w in win], np.int64)
    ref_mat = hashes_to_matrix([refs[k] for k in order])
    pi, pj = refs_windowed_native(
        np.ascontiguousarray(ref_mat).view(np.uint64),
        np.ascontiguousarray(s._packed_matrix()).view(np.uint64),
        lo, hi, tol_int,
    )
    per_ref: list[list[str]] = [[] for _ in refs]
    for i, j in zip(pi.tolist(), pj.tolist()):
        per_ref[order[i]].append(s.entries[j].src_path)
    return [
        (r.src_path, tuple(m)) for r, m in zip(refs, per_ref) if m
    ]


# -- phases -------------------------------------------------------------------


def phase_device(ctx) -> None:
    import jax

    from vid_dup_finder_lib_tpu import platform
    from vid_dup_finder_lib_tpu.utils.jaxconfig import cache_dir

    dev = jax.devices()[0]
    log(f"  platform={dev.platform} device_kind={dev.device_kind}"
        f" count={len(jax.devices())}")
    log(f"  card (name, power limit): {ctx['card']}")
    log(f"  bytes_limit={platform.bytes_limit()}")
    log("  compile cache: "
        + (os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(cache_dir())))


def phase_hashing(ctx) -> None:
    from vid_dup_finder_lib_tpu.models.pipeline import hash_raw_frames_device
    from vid_dup_finder_lib_tpu.ops.golden import (
        crop_resize_golden,
        hash_bits_golden,
    )
    from vid_dup_finder_lib_tpu.ops.hash_kernel import hash_cubes_device
    from vid_dup_finder_lib_tpu.ops.letterbox import cropdetect_letterbox
    from vid_dup_finder_lib_tpu.ops.letterbox_device import (
        cropdetect_letterbox_device,
    )
    from vid_dup_finder_lib_tpu.ops.resize_device import resize_frames_device
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    log("  decode stays on the host and is outside this script (the card"
        " machine is not sure to have OpenCV, GStreamer or libdav1d);"
        " frames are made from the seed")
    b, h, w = ctx["videos"], 120, 160
    rng = np.random.default_rng(ctx["seed"] + 2)
    frames = rng.integers(0, 256, (b, 16, h, w), dtype=np.uint8)
    # letterbox bars: none, top/bottom, left/right, both
    for i in range(b):
        kind = i % 4
        if kind in (1, 3):
            frames[i, :, :12] = 0
            frames[i, :, -12:] = 0
        if kind in (2, 3):
            frames[i, :, :, :16] = 0
            frames[i, :, :, -16:] = 0

    # device letterbox detection and resize vs the host golden path
    crops_dev = cropdetect_letterbox_device(frames)
    crops_host = [cropdetect_letterbox(list(frames[i])) for i in range(b)]
    bad = sum(1 for a, c in zip(crops_dev, crops_host) if a != c)
    log(f"  letterbox crops: {bad} of {b} differ from the host")
    assert bad == 0, "device letterbox crops differ from the host"
    by_crop: dict = {}
    for i, c in enumerate(crops_dev):
        by_crop.setdefault(c, []).append(i)
    cubes_dev = np.empty((b, 16, 16, 16), np.uint8)
    for crop, idxs in by_crop.items():
        cubes_dev[idxs] = resize_frames_device(frames[idxs], crop)
    cubes_host = np.stack([
        np.stack([crop_resize_golden(f, crops_host[i]) for f in frames[i]])
        for i in range(b)
    ])
    resize_diff = int((cubes_dev != cubes_host).sum())
    log(f"  resize: {resize_diff} of {cubes_host.size} pixels differ"
        f" ({len(by_crop)} crop buckets)")
    assert resize_diff == 0, "device resize is not bit-exact"

    def flips(packed, cubes):
        total = worst = 0
        for i in range(cubes.shape[0]):
            d = int((hash_bits_golden(cubes[i])
                     != VideoHash.from_packed_u32(packed[i]).hash_bits()).sum())
            total += d
            worst = max(worst, d)
        return total, worst

    # tests/test_golden_model.py's bound (8 flips over 512 cubes, at most
    # 2 in one hash), scaled to the corpus: ~1.6e-5 of the bits
    allowed = -(-8 * b // 512)
    packed_raw, t_raw = timed(hash_raw_frames_device, frames)
    f_raw, w_raw = flips(packed_raw, cubes_host)
    log(f"  hash_raw_frames_device: {b} videos {t_raw:.3f} s (compile"
        f" included); {f_raw} bits flipped of {b * 1000} (allowed"
        f" {allowed}), worst hash {w_raw}")
    assert f_raw <= allowed and w_raw <= 2

    cubes = rng.integers(0, 256, (b, 16, 16, 16), dtype=np.uint8)
    cubes[: b // 2] = (128 + rng.integers(-2, 3, (b // 2, 16, 16, 16))
                       ).astype(np.uint8)  # low contrast: near-zero signs
    hash_cubes_device(cubes)  # compile
    times = []
    for _ in range(5):
        packed_c, t = timed(hash_cubes_device, cubes)
        times.append(t)
    f_c, w_c = flips(packed_c, cubes)
    log(f"  hash_cubes_device: batch {b} median {np.median(times):.6f} s"
        f" (min {min(times):.6f}, host transfer included); {f_c} bits"
        f" flipped of {b * 1000} (allowed {allowed}), worst hash {w_c}")
    assert f_c <= allowed and w_c <= 2
    ctx["kernel_times"]["hash_cubes_device_s"] = float(np.median(times))


def phase_self_search(ctx) -> None:
    import vid_dup_finder_lib_tpu as vdf
    from vid_dup_finder_lib_tpu.native import available

    assert available(), "the native C++ reference could not be built"
    packed, durations, paths, hashes, planted = make_library(
        ctx["n"], ctx["seed"]
    )
    ctx["lib"] = (packed, durations, paths, hashes)
    ref, t_nat = timed(vdf.search, hashes, TOL, backend="native")
    ref = group_lists(ref)
    ctx["groups"] = ref
    log(f"  native (all host threads): {len(ref)} groups {t_nat:.2f} s")
    found = {frozenset(d for d in g[1]) for g in ref}
    missing = sum(1 for p in planted if frozenset(p) not in found)
    log(f"  planted clusters missing from the groups: {missing}")
    assert missing == 0
    for backend in ("auto", "pallas_windowed", "pallas_split",
                    "pallas_streamed", "device"):
        got, t = timed(vdf.search, hashes, TOL, backend=backend)
        same = group_lists(got) == ref
        log(f"  {backend}: {len(got)} groups {t:.2f} s (first call,"
            f" compile included) identical={same}")
        assert same, f"{backend} groups differ from native"


def phase_resident(ctx) -> None:
    import vid_dup_finder_lib_tpu as vdf
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        IncrementalDeviceLibrary,
    )

    packed, durations, paths, hashes = ctx["lib"]
    lib = IncrementalDeviceLibrary(capacity=1 << 16)
    t0 = time.perf_counter()
    for a in range(0, packed.shape[0], 1 << 16):
        lib.append(packed[a : a + (1 << 16)])
    t_app = time.perf_counter() - t0
    ctx["device_lib"] = lib
    for k in range(2):
        got, t = timed(vdf.search, hashes, TOL, device_library=lib)
        same = group_lists(got) == ctx["groups"]
        log(f"  search(device_library=) run {k}: {len(got)} groups"
            f" {t:.2f} s identical={same} (append {t_app:.2f} s)")
        assert same


def phase_refs(ctx) -> None:
    import vid_dup_finder_lib_tpu as vdf

    packed, durations, paths, hashes = ctx["lib"]
    refs = make_refs(packed, durations, ctx["refs"], ctx["seed"])
    exp = native_refs_expected(hashes, refs, int(TOL * 1000))
    log(f"  native windowed sweep: {len(exp)} refs with matches")
    assert exp
    runs = [
        ("resident library", {"device_library": ctx["device_lib"]}, {}),
        ("host library", {}, {}),
        ("windowed state", {}, {"VDF_REFS_WINDOWED": "1"}),
    ]
    for name, kw, env in runs:
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            got, t = timed(vdf.search_with_references, refs, hashes, TOL,
                           **kw)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        same = group_lists(got) == exp
        log(f"  search_with_references ({name}): {len(got)} groups"
            f" {t:.2f} s identical={same}")
        assert same, name


def phase_kernels(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from bench import self_search_bounds
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    packed, durations, paths, hashes = ctx["lib"]
    bounds = self_search_bounds(durations)
    state = hp.PallasSearchState(packed, bounds)
    geom = state.geom
    launches = hp._plan_launches(state)
    pick = np.linspace(0, len(launches) - 1, 64).astype(int)
    batch = [launches[i] for i in pick]
    scal = np.zeros((64, geom.n_scal), np.int32)
    hp._fill_scalars(scal, batch, state, 350, state.n, None)
    scal_d = jnp.asarray(scal)
    ops = (state.pm1, state.pm1, state.bounds_dev, state.row_lo_dev)
    log(f"  1M plan: {len(launches)} launches of {geom.tile_m}x"
        f"{geom.band_tiles * geom.tile_n}; 64 taken across the plan")

    def scan_of(one):
        @jax.jit
        def f(s_all, *a):
            return jax.lax.scan(lambda _, s: (None, one(s, *a)), None,
                                s_all)[1]
        return f

    def best(f, reps=7):
        jax.block_until_ready(f(scal_d, *ops))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(scal_d, *ops))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    builders = {
        "pack": lambda launch: hp._build_chunk(launch, geom),
        "counts": lambda launch: hp._build_chunk_counts(launch, geom),
        "tile_counts": lambda launch: hp._build_chunk_counts(
            launch, geom, True),
    }
    hits = 0
    for mode, build in builders.items():
        one_t = build("triton")
        one_p = build("plain")
        comp = jax.jit(one_t).lower(scal_d[0], *ops).compile()
        log(f"  triton {mode}: memory_analysis {comp.memory_analysis()}")
        f_t, f_p = scan_of(one_t), scan_of(one_p)
        got = jax.tree_util.tree_map(np.asarray, f_t(scal_d, *ops))
        want = jax.tree_util.tree_map(np.asarray, f_p(scal_d, *ops))
        exact = all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))
        if mode == "pack":
            hits = int(np.count_nonzero(want[1]))
        # alternate plain, triton, triton, plain
        tp1, tt1, tt2, tp2 = best(f_p), best(f_t), best(f_t), best(f_p)
        t_p, t_t = (tp1 + tp2) / 2, (tt1 + tt2) / 2
        log(f"  {mode}: exact={exact}; 64 launches plain {t_p:.6f} s"
            f" ({tp1:.6f}, {tp2:.6f}), triton {t_t:.6f} s ({tt1:.6f},"
            f" {tt2:.6f}) on {ctx['card']}")
        ctx["kernel_times"][f"{mode}_64_launches_plain_s"] = t_p
        ctx["kernel_times"][f"{mode}_64_launches_triton_s"] = t_t
        assert exact, f"triton {mode} launch differs from plain"
    log(f"  hit tiles among the 64 launches: {hits}")

    # the whole 1M sweep with each launch, in turn: plain, triton,
    # triton, plain (the state stays resident)
    saved = hp.sweep_launch
    ref_pairs = None
    sweep = {}
    try:
        for launch in ("plain", "triton"):  # compile both first
            hp.sweep_launch = lambda launch=launch: launch
            hp.banded_adjacency_pallas(None, bounds, 350, state=state)
        for launch in ("plain", "triton", "triton", "plain"):
            hp.sweep_launch = lambda launch=launch: launch
            (ii, jj), t = timed(
                hp.banded_adjacency_pallas, None, bounds, 350, state=state
            )
            sweep.setdefault(launch, []).append(t)
            if ref_pairs is None:
                ref_pairs = (ii, jj)
            assert np.array_equal(ii, ref_pairs[0]) and np.array_equal(
                jj, ref_pairs[1])
            log(f"  1M sweep, {launch} launch: {t:.4f} s, {len(ii)} pairs,"
                f" phases {hp.LAST_SWEEP_PHASES}")
    finally:
        hp.sweep_launch = saved
    for launch, ts in sweep.items():
        ctx["kernel_times"][f"sweep_1M_{launch}_s"] = float(np.mean(ts))
    log(f"  1M sweep end to end: plain {np.mean(sweep['plain']):.4f} s,"
        f" triton {np.mean(sweep['triton']):.4f} s on {ctx['card']}")


def phase_four_cards(ctx) -> None:
    import jax

    import vid_dup_finder_lib_tpu as vdf

    assert len(jax.devices()) == 4, f"need 4 devices, have {jax.devices()}"
    packed, durations, paths, hashes, planted = make_library(
        ctx["n"], ctx["seed"]
    )
    one, t_one = timed(vdf.search, hashes, TOL, backend="pallas")
    ring, t_ring = timed(vdf.search, hashes, TOL, backend="ring")
    one, ring = group_lists(one), group_lists(ring)
    found = {frozenset(g[1]) for g in ring}
    missing = sum(1 for p in planted if frozenset(p) not in found)
    log(f"  self-search n={ctx['n']}: one device {t_one:.2f} s, ring on 4"
        f" {t_ring:.2f} s (first calls, compile included);"
        f" identical={one == ring}; planted missing {missing}")
    assert one == ring and missing == 0
    ring2, t_ring2 = timed(vdf.search, hashes, TOL, backend="ring")
    log(f"  ring again: {t_ring2:.2f} s identical="
        f"{group_lists(ring2) == one}")
    assert group_lists(ring2) == one

    refs = make_refs(packed, durations, ctx["refs"], ctx["seed"])
    res = {}
    for sharded in ("0", "1", "1"):
        old = {k: os.environ.get(k)
               for k in ("VDF_REFS_SHARDED", "VDF_REFS_WINDOWED")}
        os.environ.update(VDF_REFS_SHARDED=sharded, VDF_REFS_WINDOWED="1")
        try:
            got, t = timed(vdf.search_with_references, refs, hashes, TOL)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        res.setdefault(sharded, group_lists(got))
        log(f"  refs {len(refs)} vs {ctx['n']}, sharded={sharded}:"
            f" {len(got)} groups {t:.2f} s identical="
            f"{group_lists(got) == res['0']}")
        assert group_lists(got) == res["0"]


# -- runner -------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-device ring and sharded refs")
    ap.add_argument("--n", type=int, default=None,
                    help="library size (default 1M; 4M with --four-cards)")
    ap.add_argument("--refs", type=int, default=10_000)
    ap.add_argument("--videos", type=int, default=4096)
    ap.add_argument("--rehearse-on-cpu", action="store_true",
                    help="run on the CPU backend; never prints a result")
    args = ap.parse_args()

    if args.rehearse_on_cpu:
        # the Triton launches run interpreted on the CPU: tiny tiles; the
        # references search takes the device path at any size
        os.environ.update(
            JAX_PLATFORMS="cpu", VDF_TILE_M="128", VDF_TILE_N="256",
            VDF_BAND_TILES="2", VDF_REFS_DEVICE_THRESHOLD="0",
        )
    import jax

    if not args.rehearse_on_cpu:
        import vid_dup_finder_lib_tpu  # noqa: F401  (fails outside the repo)

        if jax.default_backend() != "gpu":
            print(f"chip_smoke.py needs a CUDA GPU; JAX found"
                  f" {jax.default_backend()!r}", file=sys.stderr)
            return 2
    from vid_dup_finder_lib_tpu.utils.jaxconfig import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    ctx = {
        "seed": args.seed,
        "n": args.n or (4_000_000 if args.four_cards else 1_000_000),
        "refs": args.refs,
        "videos": args.videos,
        "card": card_line(),
        "kernel_times": {},
    }
    phases = [("device", phase_device)]
    if args.four_cards:
        phases.append(("four cards", phase_four_cards))
    else:
        phases += [
            ("hashing", phase_hashing),
            ("self-search", phase_self_search),
            ("resident library", phase_resident),
            ("references", phase_refs),
            ("kernels", phase_kernels),
        ]
    failed = []
    t_all = time.perf_counter()
    for name, fn in phases:
        log(f"[{name}]")
        t0 = time.perf_counter()
        try:
            fn(ctx)
            log(f"[{name}] ok {time.perf_counter() - t0:.1f} s")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            log(f"[{name}] FAILED {time.perf_counter() - t0:.1f} s")
            failed.append(name)
            if name in ("device", "self-search"):
                break  # later phases need its outputs
    log(f"kernel times: {json.dumps(ctx['kernel_times'])}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(ctx["card"])  # name, power limit: nvidia-smi's own line(s)
    if failed:
        log(f"failed phases: {failed}")
        return 1
    if args.rehearse_on_cpu:
        log("rehearsal on the CPU backend: no result")
        return 3
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
