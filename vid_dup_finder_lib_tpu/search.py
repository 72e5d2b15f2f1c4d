"""Duplicate search: the public ``search`` / ``search_with_references`` API.

Semantics are an exact behavioral port of the reference's greedy search
(``vid_dup_finder_lib/src/video_hashing/search_algorithm.rs`` and
``video_dup_finder.rs``):

* entries are sorted by ``(duration, src_path)`` (bytewise path order) for
  determinism;
* ``search_self`` sweeps a two-pointer duration window (rhs advances while
  ``duration <= int(lhs_duration * 1.1)``), each target greedily consumes
  unmatched candidates within ``int(tolerance * 1000)`` Hamming distance;
* ``search_with_references`` uses a symmetric ``[int(0.95 d), int(1.05 d)]``
  window and does not consume candidates.

The device acceleration keeps these semantics bit-for-bit: the device computes
the *adjacency* (which pairs are within tolerance) with a tiled plus/minus-one
int8 matmul sweep, and the greedy pass is replayed on host in the reference's
sort order over that adjacency (SURVEY.md section 3.2).  Because durations
are sorted, the reference's matched-entry skipping in ``advance_rhs`` never
changes the candidate set, so replaying over a precomputed duration-windowed
adjacency is exact.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from . import platform
from .definitions import (
    REF_SEARCH_DURATION_HI,
    REF_SEARCH_DURATION_LO,
    SELF_SEARCH_DURATION_FACTOR,
    TOLERANCE_SCALING_FACTOR,
)
from .match_group import MatchGroup, TooFewEntries
from .video_hash import VideoHash, VideoHashBatch, hashes_to_matrix

# Auto backend: use the device (JAX) distance kernel above this many entries.
_DEVICE_SEARCH_THRESHOLD = 4096

# search_with_references switches to blocked-matmul batching at this many refs.
_BATCHED_REFS_THRESHOLD = 64

# total ref-window comparisons above which the batched refs search runs
# on the device instead of the host
_DEVICE_REFS_WORK_THRESHOLD = int(
    os.environ.get("VDF_REFS_DEVICE_THRESHOLD", str(1 << 24))
)

HASH_BITS_F = 1024.0  # +/-1 dot covers all storage bits


def _sort_key(h: VideoHash):
    # search_algorithm.rs:54-60 — (duration, src_path); PathBuf compares
    # bytewise, which os.fsencode reproduces for any unicode path.
    return (h.duration, os.fsencode(h.src_path))


def _tolerance_int(tolerance: float) -> int:
    # `(tolerance * 1000.0) as u32` — Rust float->u32 casts saturate at 0.
    return max(0, int(tolerance * TOLERANCE_SCALING_FACTOR))


class Search:
    """Sorted hash store for duplicate searches (search_algorithm.rs:19-199)."""

    def __init__(self, hashes: Iterable[VideoHash] = ()):  # Search::from + seed
        # Bulk fast path: a VideoHashBatch (many_from_packed_u32) carries
        # its duration / bytewise-path / packed-matrix columns, so the
        # ctor does ZERO per-object Python work — at 16M entries the
        # loops below cost ~10 s per Search, the dominant steady-state
        # overhead of the public refs search.
        packed_mat: np.ndarray | None = None
        durations = paths = None
        if (
            isinstance(hashes, VideoHashBatch)
            and hashes.arrays_valid
            and hashes.paths_bytes is not None
        ):
            durations = hashes.durations
            paths = hashes.paths_bytes
            packed_mat = hashes.packed_u32
        entries = list(hashes)
        # Vectorized (duration, bytewise-path) sort: PathBuf compares
        # bytewise and numpy's S dtype does too, so an all-ASCII path
        # array sorts identically under np.lexsort (stable, like
        # Python's sorted) at C speed — the per-element fsencode key
        # costs ~2 us/entry (~30 s at 16M).  Non-ASCII paths (where
        # UTF-8 byte order and str code-point order can disagree on
        # surrogate-escaped bytes) fall back to the exact Python key.
        if entries and durations is None:
            durations = np.fromiter(
                (e.duration for e in entries),
                dtype=np.int64,
                count=len(entries),
            )
            try:
                paths = np.array(
                    [os.fspath(e.src_path) for e in entries],
                    dtype=np.bytes_,
                )
            except (UnicodeEncodeError, TypeError, ValueError):
                paths = None
        # whether the ctor had to re-sort the input (None = unknown, the
        # non-ASCII Python-key fallback): attach_device_library's
        # identity-order default is only safe when it did not
        self._ctor_resorted: bool | None = False
        if entries:
            if paths is not None:
                # O(n) sortedness check first: bulk handoffs (device
                # libraries, cache dumps) arrive pre-sorted, and the
                # lexsort itself is the ctor's dominant cost
                d_nondec = durations[1:] >= durations[:-1]
                is_sorted = bool(d_nondec.all()) and bool(
                    (
                        (durations[1:] != durations[:-1])
                        | (paths[1:] >= paths[:-1])
                    ).all()
                )
                self._ctor_resorted = not is_sorted
                if not is_sorted:
                    order = np.lexsort((paths, durations))
                    ent_arr = np.empty(len(entries), dtype=object)
                    ent_arr[:] = entries
                    entries = ent_arr[order].tolist()
                    durations = durations[order]
                    if packed_mat is not None:
                        packed_mat = np.ascontiguousarray(
                            packed_mat[order]
                        )
            else:
                entries.sort(key=_sort_key)
                durations = np.fromiter(
                    (e.duration for e in entries),
                    dtype=np.int64,
                    count=len(entries),
                )
                packed_mat = None
                self._ctor_resorted = None
        if durations is None:
            durations = np.zeros(0, dtype=np.int64)
        self.entries: list[VideoHash] = entries
        self.matched = np.zeros(len(self.entries), dtype=bool)
        self._durations = durations
        # CSR adjacency: row i's in-tolerance candidates (sorted, j > i)
        # are _adj_j[_adj_off[i] : _adj_off[i + 1]]
        self._adj_j: np.ndarray | None = None
        self._adj_off: np.ndarray | None = None
        self._tol_of_adjacency: int | None = None
        # device-resident candidate matrix (attach_device_library)
        self._cands_dev = None
        # attached IncrementalDeviceLibrary + per-sorted-entry insertion
        # index: self-search then builds its sweep state straight from
        # the resident packed rows (no host matrix, no h2d re-upload)
        self._library = None
        self._library_order: np.ndarray | None = None
        self._library_geom = None
        # host packed matrix cache: rebuilding costs ~1.3 s per call at
        # 1M entries and every search path needs it.  A VideoHashBatch
        # seeds it for free (its rows ARE views into this matrix).
        self._packed_mat: np.ndarray | None = packed_mat

    def _packed_matrix(self) -> np.ndarray:
        if self._packed_mat is None:
            self._packed_mat = hashes_to_matrix(self.entries)
        return self._packed_mat

    def attach_device_library(
        self, library, insertion_paths, geom=None
    ) -> None:
        """Use a device-resident packed library as the candidate matrix.

        ``library``: an ``ops.hamming_pallas.IncrementalDeviceLibrary``
        whose rows were appended in ``insertion_paths`` order (one
        src_path per row).  Every entry of this Search must appear in
        ``insertion_paths``.  Both search flavors then skip the
        128 B/hash host-matrix upload:

        * ``search_self`` builds its Pallas sweep state directly from
          the resident rows via ``IncrementalDeviceLibrary.state()``
          (zero-copy when rows were appended pre-sorted);
        * batched multi-reference searches assemble the [cands | refs]
          device matrix from the resident rows — only the refs ride h2d.

        The sort into this Search's (duration, src_path) order happens
        as a device gather (or is elided for identity order).
        ``geom``: optional kernel tile ``Geometry`` for the self-search
        sweep state (default: the configured production geometry).
        """
        self._library_geom = geom
        if insertion_paths is None:
            # rows were appended in this Search's sorted entry order
            if library.n != len(self.entries):
                raise ValueError(
                    f"attach_device_library(insertion_paths=None): the"
                    f" library holds {library.n} rows but this Search"
                    f" has {len(self.entries)} entries — identity order"
                    f" requires exactly one row per entry (pass"
                    f" insertion_paths for a superset library)"
                )
            # a misaligned identity order would sweep the WRONG rows and
            # return silently wrong groups.  When this Search's input
            # arrived pre-sorted the alignment is self-evident (the
            # common bulk flow: append, then Search over the same
            # order) and this costs nothing; when the ctor had to
            # re-sort, spot-check a few sampled library rows against
            # the sorted entries' packed rows (one small d2h) before
            # trusting the caller's claim.
            if self._ctor_resorted is not False and self.entries:
                n = len(self.entries)
                sample = sorted({0, n // 3, (2 * n) // 3, n - 1})
                got = self._library_rows(library, sample)
                for k, i in enumerate(sample):
                    if not np.array_equal(
                        got[k], self.entries[i].packed_u32()
                    ):
                        raise ValueError(
                            f"attach_device_library(insertion_paths="
                            f"None): library row {i} does not match"
                            f" this Search's sorted entry {i} — the"
                            f" rows were not appended in sorted"
                            f" (duration, src_path) order.  Pass"
                            f" insertion_paths (one src_path per"
                            f" appended row) or append pre-sorted."
                        )
            order = np.arange(len(self.entries), dtype=np.int64)
        else:
            idx = {p: i for i, p in enumerate(insertion_paths)}
            try:
                order = np.array(
                    [idx[e.src_path] for e in self.entries],
                    dtype=np.int64,
                )
            except KeyError as e:
                raise ValueError(
                    f"attach_device_library: entry src_path {e.args[0]!r}"
                    f" has no row in insertion_paths — every Search"
                    f" entry must have been appended to the library"
                ) from None
            if library.n < len(idx):
                raise ValueError(
                    f"attach_device_library: insertion_paths names"
                    f" {len(idx)} rows but the library holds only"
                    f" {library.n}"
                )
        self._library = library
        self._library_order = order
        self._cands_dev = None  # gathered lazily by the refs paths
        self._adj_j = self._adj_off = None  # adjacency source changed

    @staticmethod
    def _library_rows(library, idx) -> np.ndarray:
        """Host fetch of a few library rows (identity-order spot-check)."""
        import jax.numpy as jnp

        packed = library._packed
        if hasattr(packed, "take_rows"):  # ChunkedPackedStore
            return packed.take_rows(np.asarray(idx, dtype=np.int64))
        return np.asarray(
            jnp.take(
                packed,
                jnp.asarray(np.asarray(idx, dtype=np.int32)),
                axis=0,
            )
        )

    def _ensure_cands_dev(self):
        """Sorted-order device gather of the attached library's rows
        (refs-search candidate matrix); cached after the first call."""
        if self._cands_dev is None and self._library is not None:
            import jax.numpy as jnp

            from .ops.hamming_pallas import (
                ChunkedPackedStore,
                _incremental_jits,
            )

            n = len(self.entries)
            chunked = isinstance(
                self._library._packed, ChunkedPackedStore
            )
            if self._library.n == n and np.array_equal(
                self._library_order, np.arange(n, dtype=np.int64)
            ):
                # rows appended pre-sorted: the library buffer IS the
                # candidate matrix (pads beyond n are zeros and masked
                # by n_cands) — no index h2d, no 128 B/hash gather
                # output re-allocated per fresh Search.  A chunked
                # store (past the single-allocation watermark) hands
                # off the same way; the windowed refs state slices its
                # column windows across the chunks.
                self._cands_dev = self._library._packed
                self._library._shared = True
            elif chunked:
                raise ValueError(
                    f"references search over a chunked device library "
                    f"({self._library.n} hashes past the single-"
                    f"allocation watermark, VDF_MAX_ALLOC_GB) requires "
                    f"rows appended duration-sorted (identity order) — "
                    f"a permutation gather cannot fit HBM at this scale"
                )
            else:
                _, gather_rows = _incremental_jits()
                self._cands_dev = gather_rows(
                    self._library._packed,
                    jnp.asarray(self._library_order.astype(np.int32)),
                )
        return self._cands_dev

    def seed(self, new_entries: Iterable[VideoHash]) -> None:
        self.entries = sorted(
            list(self.entries) + list(new_entries), key=_sort_key
        )
        self.matched = np.zeros(len(self.entries), dtype=bool)
        self._durations = np.array(
            [e.duration for e in self.entries], dtype=np.int64
        )
        self._adj_j = self._adj_off = None
        # attached library no longer covers entries
        self._cands_dev = None
        self._library = None
        self._library_order = None
        self._packed_mat = None

    # -- distance plumbing ---------------------------------------------------

    def _distance(self, i: int, j: int) -> int:
        return self.entries[i].hamming_distance(self.entries[j])

    def _ensure_adjacency(self, tolerance_int: int, backend: str) -> None:
        """Precompute, for every entry i, the sorted candidate indices j > i
        within the self-search duration window and Hamming tolerance."""
        if (
            self._adj_j is not None
            and self._tol_of_adjacency == tolerance_int
        ):
            return
        n = len(self.entries)
        bounds = self._self_search_bounds()
        if self._library is not None and backend in (
            "auto",
            "pallas",
            "pallas_streamed",
            "pallas_windowed",
            "pallas_split",
        ):
            # device-resident self-search:
            # the sweep state is built straight from the attached
            # library's packed rows — no host matrix, no 128 B/hash
            # h2d re-upload.  Identity insertion order hands the
            # library buffer over zero-copy; otherwise a device
            # gather sorts it.  resident/windowed/split selection
            # follows the same auto rules as the upload path.
            from .ops.hamming_pallas import banded_adjacency_pallas

            forced = {
                "pallas": (False, False),
                "pallas_streamed": (False, False),
                "pallas_windowed": (True, False),
                "pallas_split": (True, True),
            }.get(backend, (None, None))
            st = self._library.state(
                self._library_order,
                bounds,
                windowed=forced[0],
                split=forced[1],
                geom=self._library_geom,
            )
            pairs_i, pairs_j = banded_adjacency_pallas(
                None, bounds, tolerance_int, state=st
            )
        else:
            from .ops.hamming import banded_adjacency

            pairs_i, pairs_j = banded_adjacency(
                self._packed_matrix(),
                bounds,
                tolerance_int,
                backend=backend,
            )
        # every backend returns pairs lexsorted by (i, j), so the CSR
        # build is two vectorized ops — a per-pair Python append walled
        # at dense-adjacency scale (millions of pairs)
        self._adj_j = pairs_j
        self._adj_off = np.searchsorted(pairs_i, np.arange(n + 1))
        self._tol_of_adjacency = tolerance_int

    def _self_search_bounds(self) -> np.ndarray:
        """For each i, the exclusive upper index bound of the +10% duration
        window (search_algorithm.rs:99)."""
        thresh = (
            self._durations.astype(np.float64) * SELF_SEARCH_DURATION_FACTOR
        ).astype(np.int64)  # trunc, like `as u32`
        return np.searchsorted(self._durations, thresh, side="right")

    # -- searches ----------------------------------------------------------------

    def search_self(self, tolerance: float, backend: str = "auto") -> list[list[str]]:
        """All-pairs greedy dedup (search_algorithm.rs:81-171)."""
        n = len(self.entries)
        if n == 0:
            return []
        tol = _tolerance_int(tolerance)

        use_adjacency = backend != "naive" and (
            backend
            in (
                "device",
                "host",
                "pallas",
                "pallas_streamed",
                "pallas_windowed",
                "pallas_split",
                "native",
                "band",
                "ring",
            )
            or n >= _DEVICE_SEARCH_THRESHOLD
            or self._library is not None
        )
        if use_adjacency:
            self._ensure_adjacency(tol, backend)

        bounds = self._self_search_bounds()
        matched = self.matched
        ret: list[list[str]] = []
        if use_adjacency:
            assert self._adj_j is not None and self._adj_off is not None
            # greedy consume, vectorized two ways while replaying the
            # reference's consume order exactly:
            # (a) within one target's scan, every still-unmatched
            #     in-tolerance candidate is consumed at once
            #     (search_algorithm.rs:149-156) — no per-j decision
            #     depends on an earlier j of the SAME scan;
            # (b) rows with NO in-tolerance candidate are skipped
            #     entirely: they can't form a group or consume anything,
            #     and since candidates satisfy j > lhs an empty row can
            #     never be a LATER row's candidate, so its visit-marking
            #     is inert during the loop.  Without this skip the
            #     replay walks all n rows in Python (~4.6 s at 1M vs
            #     7 ms with 600 pairs).  The reference's all-visited
            #     post-condition (search_algorithm.rs:131-136) is
            #     restored by the fill below.
            rows = np.nonzero(self._adj_off[1:] > self._adj_off[:-1])[0]
            for lhs in rows:
                lhs = int(lhs)
                if matched[lhs]:
                    continue
                matched[lhs] = True
                cands = self._adj_j[
                    self._adj_off[lhs] : self._adj_off[lhs + 1]
                ]
                sel = cands[~matched[cands]]
                if sel.size == 0:
                    continue
                match_vec = [self.entries[int(j)].src_path for j in sel]
                matched[sel] = True
                match_vec.append(self.entries[lhs].src_path)
                ret.append(match_vec)
            matched[:] = True
        else:
            for lhs in range(n):
                if matched[lhs]:
                    continue
                matched[lhs] = True
                match_vec = []
                for j in range(lhs + 1, int(bounds[lhs])):
                    if matched[j]:
                        continue
                    if self._distance(lhs, int(j)) <= tol:
                        match_vec.append(self.entries[int(j)].src_path)
                        matched[j] = True
                if match_vec:
                    match_vec.append(self.entries[lhs].src_path)
                    ret.append(match_vec)
        ret.reverse()  # search_algorithm.rs:136,167
        return ret

    def _duration_slice(self, duration_secs: int) -> tuple[int, int]:
        """[0.95 d, 1.05 d] window bounds (search_algorithm.rs:173-185)."""
        lo = int(float(duration_secs) * REF_SEARCH_DURATION_LO)
        hi = int(float(duration_secs) * REF_SEARCH_DURATION_HI)
        lhs = int(np.searchsorted(self._durations, lo, side="left"))
        rhs = int(np.searchsorted(self._durations, hi, side="right"))
        return lhs, rhs

    def search_one(
        self, target: VideoHash, tolerance: float, consume: bool
    ) -> list[str]:
        """(search_algorithm.rs:63-77)"""
        tol = _tolerance_int(tolerance)
        lhs, rhs = self._duration_slice(target.duration)
        ret: list[str] = []
        if rhs > lhs:
            dists = _distances_one_to_many(
                target, self.entries[lhs:rhs]
            )
            for off, d in enumerate(dists):
                j = lhs + off
                if not self.matched[j] and d <= tol:
                    ret.append(self.entries[j].src_path)
                    if consume:
                        self.matched[j] = True
        return ret

    def search_with_references(
        self, references: Sequence[VideoHash], tolerance: float, consume: bool
    ) -> list[list[str]]:
        return [self.search_one(r, tolerance, consume) for r in references]

    def search_with_references_batched(
        self, references: Sequence[VideoHash], tolerance: float
    ) -> list[list[str]]:
        """Batched (non-consuming) multi-reference search.

        Output-identical to looping ``search_one(consume=False)`` per ref
        (video_dup_finder.rs:19-46's semantics), but distances are computed
        as blocked +/-1 matmuls: references are processed in duration-sorted
        blocks whose candidate windows are contiguous in the sorted entry
        array, so one [R_B, window] distance block serves a whole ref block.
        """
        tol = _tolerance_int(tolerance)
        refs = list(references)
        if not refs or not self.entries:
            return [[] for _ in refs]

        from .ops.hamming import unpack_pm1_host

        order = sorted(range(len(refs)), key=lambda k: refs[k].duration)

        # large workloads ride the device: the two-phase int8 sweep over
        # the per-ref [0.95d, 1.05d] column windows (output-identical).
        # With an attached device library the device path is used
        # unconditionally (the candidate matrix is already resident).
        windows_all = [self._duration_slice(refs[k].duration) for k in order]
        work = sum(w[1] - w[0] for w in windows_all)
        resident = self._ensure_cands_dev() is not None
        # The CPU backend stays on the native/host branches below; a
        # threshold of 0 (tests, VDF_REFS_DEVICE_THRESHOLD=0) still
        # forces the device path there.
        if resident or (
            work >= _DEVICE_REFS_WORK_THRESHOLD
            and (
                platform.device_sweep() or _DEVICE_REFS_WORK_THRESHOLD <= 0
            )
        ):
            ref_mat = hashes_to_matrix([refs[k] for k in order])
            lo = np.array([w[0] for w in windows_all], np.int64)
            hi = np.array([w[1] for w in windows_all], np.int64)
            cands_mat = None if resident else self._packed_matrix()
            n_entries = len(self.entries)
            # windowed refs path: candidate libraries beyond the
            # resident +/-1 budget ride a sliding column window over the
            # device-resident packed matrix — no chunk loop, no per-(r, n)
            # jit specialization (shapes are bucketed; see
            # ops.hamming_pallas.WindowedRefsState)
            win_threshold = int(
                os.environ.get(
                    "VDF_REFS_WINDOWED_THRESHOLD", platform.resident_rows()
                )
            )
            use_windowed = (resident or platform.device_sweep()) and (
                n_entries >= win_threshold
                or os.environ.get("VDF_REFS_WINDOWED") == "1"
            )
            # a chunked candidate store (past the single-allocation
            # watermark) can only be consumed by the windowed state,
            # whose column windows slice across chunk seams — the
            # resident chunk loop below indexes the store directly, so
            # knobs cannot route a chunked library off this path
            cands_chunked = False
            if resident:
                from .ops.hamming_pallas import ChunkedPackedStore

                cands_chunked = isinstance(
                    self._cands_dev, ChunkedPackedStore
                )
            if cands_chunked or (
                use_windowed
                and os.environ.get("VDF_REFS_WINDOWED") != "0"
            ):
                # several devices: shard the duration-sorted refs over
                # the mesh (packed candidates replicated, per-shard
                # sliding column windows, zero hot-loop collectives) —
                # auto with several GPUs, forceable via
                # VDF_REFS_SHARDED=1
                sharded = os.environ.get("VDF_REFS_SHARDED")
                if sharded is None and platform.device_sweep():
                    import jax

                    sharded = (
                        "1" if len(jax.devices()) > 1 else None
                    )
                if cands_chunked:
                    # the sharded path replicates one flat buffer per
                    # device; a chunked store stays on the single-chip
                    # windowed state
                    sharded = None
                if sharded == "1":
                    from .parallel.refs_sharded import (
                        refs_adjacency_sharded,
                    )

                    pi, pj = refs_adjacency_sharded(
                        ref_mat, lo, hi, tol,
                        cands_packed=cands_mat,
                        cands_dev=self._cands_dev if resident else None,
                        n_cands=n_entries,
                    )
                else:
                    from .ops.hamming_pallas import (
                        refs_adjacency_windowed,
                    )

                    pi, pj = refs_adjacency_windowed(
                        ref_mat, lo, hi, tol,
                        cands_packed=cands_mat,
                        cands_dev=self._cands_dev if resident else None,
                        n_cands=n_entries,
                    )
                results = [[] for _ in refs]
                for i, j in zip(pi.tolist(), pj.tolist()):
                    jj = int(j)
                    if not self.matched[jj]:
                        results[order[int(i)]].append(
                            self.entries[jj].src_path
                        )
                return results
            # the refs kernel holds a fully-resident +/-1 candidate
            # matrix (1 KB/hash): chunk the candidate axis so huge
            # libraries never exceed HBM.  Each ref's window is clipped
            # per chunk; chunks partition the candidates, so every
            # (ref, candidate) pair is found exactly once, in ascending
            # candidate order per ref (chunks ascend, j ascends within).
            chunk = int(
                os.environ.get("VDF_REFS_CHUNK", platform.resident_rows())
            )
            results: list[list[str]] = [[] for _ in refs]
            on_device = platform.device_sweep()
            for c0 in range(0, n_entries, chunk):
                c1 = min(c0 + chunk, n_entries)
                sel = np.nonzero((lo < c1) & (hi > c0))[0]
                if sel.size == 0:
                    continue
                sub_lo = np.clip(lo[sel] - c0, 0, c1 - c0)
                sub_hi = np.clip(hi[sel] - c0, 0, c1 - c0)
                if resident:
                    # device-resident candidates: combined matrix is
                    # assembled on device, only refs ride h2d
                    from .ops.hamming_pallas import refs_adjacency_pallas

                    pi, pj = refs_adjacency_pallas(
                        ref_mat[sel], None, sub_lo, sub_hi, tol,
                        cands_dev=self._cands_dev[c0:c1],
                        n_cands=c1 - c0,
                    )
                elif on_device:
                    # the generalized two-phase sweep: per-row [lo, hi)
                    from .ops.hamming_pallas import refs_adjacency_pallas

                    pi, pj = refs_adjacency_pallas(
                        ref_mat[sel], cands_mat[c0:c1], sub_lo, sub_hi,
                        tol,
                    )
                else:
                    from .ops.hamming import windowed_adjacency_device

                    pi, pj = windowed_adjacency_device(
                        ref_mat[sel], cands_mat[c0:c1], sub_lo, sub_hi,
                        tol,
                    )
                for i, j in zip(pi.tolist(), pj.tolist()):
                    jj = int(j) + c0
                    if not self.matched[jj]:
                        results[order[int(sel[i])]].append(
                            self.entries[jj].src_path
                        )
            return results

        # CPU-only fast path: the native windowed sweep (AVX-512 where
        # available) runs each ref's exact [lo, hi) window instead of
        # host BLAS over block-union windows — same pairs, ascending j
        # per ref, matched-filter applied identically
        try:
            from .native import available as _native_ok
            from .native import refs_windowed_native
        except Exception:  # pragma: no cover - native module ships in-tree
            def _native_ok() -> bool:
                return False

        if _native_ok() and os.environ.get("VDF_REFS_NATIVE", "1") == "1":
            ref_mat = hashes_to_matrix([refs[k] for k in order])
            lo = np.array([w[0] for w in windows_all], np.int64)
            hi = np.array([w[1] for w in windows_all], np.int64)
            pi, pj = refs_windowed_native(
                np.ascontiguousarray(ref_mat).view(np.uint64),
                np.ascontiguousarray(
                    self._packed_matrix()
                ).view(np.uint64),
                lo, hi, tol,
            )
            results = [[] for _ in refs]
            for i, j in zip(pi.tolist(), pj.tolist()):
                jj = int(j)
                if not self.matched[jj]:
                    results[order[int(i)]].append(
                        self.entries[jj].src_path
                    )
            return results

        cand_pm = unpack_pm1_host(self._packed_matrix())
        results: list[list[str]] = [[] for _ in refs]

        r_block = 256
        for b0 in range(0, len(order), r_block):
            block = order[b0 : b0 + r_block]
            windows = [
                self._duration_slice(refs[k].duration) for k in block
            ]
            lo = min(w[0] for w in windows)
            hi = max(w[1] for w in windows)
            if hi <= lo:
                continue
            ref_pm = unpack_pm1_host(
                hashes_to_matrix([refs[k] for k in block])
            )
            dist = (
                HASH_BITS_F - ref_pm @ cand_pm[lo:hi].T
            ) * 0.5  # exact: integer values in f32
            for row, (k, (wlo, whi)) in enumerate(zip(block, windows)):
                ok = np.flatnonzero(
                    dist[row, wlo - lo : whi - lo] <= tol
                )
                results[k] = [
                    self.entries[wlo + int(j)].src_path
                    for j in ok
                    if not self.matched[wlo + int(j)]
                ]
        return results


def _distances_one_to_many(
    target: VideoHash, entries: list[VideoHash]
) -> np.ndarray:
    if not entries:
        return np.zeros(0, dtype=np.int64)
    mat = hashes_to_matrix(entries)
    try:
        from .native import available, distances_one_native

        if available():
            return distances_one_native(target.packed_u32(), mat)
    except Exception:
        pass
    t = target.packed_u32()[None, :]
    return np.bitwise_count(mat ^ t).sum(axis=1).astype(np.int64)


# -- public API (video_dup_finder.rs:7-46) -------------------------------------


def search(
    hashes: Iterable[VideoHash],
    tolerance: float = None,  # type: ignore[assignment]
    backend: str = "auto",
    device_library=None,
    library_paths=None,
) -> list[MatchGroup]:
    """Search for duplicates within ``hashes``; groups of mutual duplicates.

    Parity: ``vid_dup_finder_lib::search`` (video_dup_finder.rs:7-13).

    ``device_library`` + ``library_paths`` (extension beyond the
    reference API): an ``IncrementalDeviceLibrary`` whose rows are the
    packed hashes of ``hashes`` appended in ``library_paths`` order —
    the sweep state is then built from the resident rows and the
    128 B/hash host-matrix upload is skipped entirely.  Pass
    ``library_paths=None`` if rows were appended in this search's
    (duration, src_path) sorted order (zero-copy handoff).
    """
    if tolerance is None:
        from .definitions import DEFAULT_SEARCH_TOLERANCE

        tolerance = DEFAULT_SEARCH_TOLERANCE
    if backend == "auto":
        # production override without touching the reference-parity CLI
        # flag surface (arg_parse mirrors the reference's 33 flags)
        backend = os.environ.get("VDF_SEARCH_BACKEND", "auto")
    s = Search(hashes)
    if device_library is not None:
        s.attach_device_library(device_library, library_paths)
    groups = s.search_self(tolerance, backend=backend)
    out = []
    for g in groups:
        try:
            out.append(MatchGroup.new(g))
        except TooFewEntries:
            pass
    return out


def search_with_references(
    ref_hashes: Iterable[VideoHash],
    new_hashes: Iterable[VideoHash],
    tolerance: float = None,  # type: ignore[assignment]
    device_library=None,
    library_paths=None,
) -> list[MatchGroup]:
    """Find, per reference video, its duplicates among ``new_hashes``.

    Parity: ``vid_dup_finder_lib::search_with_references``
    (video_dup_finder.rs:19-46) — one reference at a time, non-consuming.

    ``device_library`` + ``library_paths`` (extension beyond the
    reference API): an ``IncrementalDeviceLibrary`` holding the packed
    candidate hashes device-resident (appended in ``library_paths``
    order) — the search then skips the candidate-matrix upload entirely
    (only refs ride h2d; see ``Search.attach_device_library``).
    """
    if tolerance is None:
        from .definitions import DEFAULT_SEARCH_TOLERANCE

        tolerance = DEFAULT_SEARCH_TOLERANCE
    s = Search(new_hashes)
    if device_library is not None:
        s.attach_device_library(device_library, library_paths)
    refs = list(ref_hashes)
    out: list[MatchGroup] = []
    if len(refs) >= _BATCHED_REFS_THRESHOLD or device_library is not None:
        all_matches = s.search_with_references_batched(refs, tolerance)
    else:
        all_matches = [
            s.search_with_references([r], tolerance, consume=False)[0]
            for r in refs
        ]
    for ref_hash, matches in zip(refs, all_matches):
        if matches:
            try:
                out.append(
                    MatchGroup.new_with_reference(ref_hash.src_path, matches)
                )
            except TooFewEntries:
                pass
    return out
