"""ChunkedPackedStore: packed libraries past the single-allocation
watermark.

Past a single-allocation watermark (VDF_MAX_ALLOC_GB) one flat
[n, 32] uint32 buffer is not allowed.  The chunked store splits the packed library across fixed-size device chunks while
sliding windows slice across at most two adjacent chunks.  These tests
pin the slice/scatter data path bit-exactly and pair-for-pair sweep
parity against the host oracle for every state that can carry a store
(split, windowed, host-sourced deferred upload, incremental library),
plus the graceful errors where chunking cannot apply.

Reference semantics being preserved at scale: the
``search_algorithm.rs:81-185`` adjacency contract (all pairs
i < j < bounds[i], hamming <= tol, lexicographic order); scaling claim
being exceeded: ``vid_dup_finder_lib/src/lib.rs:120-127``.
"""

import numpy as np
import pytest

from tests.test_split_window import TINY, _tiny_geom
from tests.test_windowed import _random_library


def _store_from_packed(packed: np.ndarray, chunk_rows: int, need: int):
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
    )

    store = ChunkedPackedStore.zeros(need, chunk_rows)
    store.set_rows(0, packed)
    return store


def test_slice_rows_bit_exact_across_chunks():
    """slice_rows == the flat-buffer slice at every offset class:
    chunk-interior, chunk-start, chunk-end and straddling."""
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
    )

    rng = np.random.default_rng(5)
    flat = rng.integers(0, 2**32, (4096, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store = ChunkedPackedStore.zeros(4096, 1024)
    assert len(store.chunks) == 4
    store.set_rows(0, flat)
    for at in (0, 256, 768, 1024, 1536, 2048 - 256, 3072, 3328):
        got = np.asarray(store.slice_rows(at, 768))
        assert np.array_equal(got, flat[at : at + 768]), at
    # writes that straddle a chunk boundary land bit-exactly too
    patch = rng.integers(0, 2**32, (512, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store.set_rows(1024 - 100, patch)
    flat[1024 - 100 : 1024 - 100 + 512] = patch
    got = np.asarray(store.slice_rows(768, 1024))
    assert np.array_equal(got, flat[768 : 768 + 1024])


def test_short_last_chunk_and_extend():
    """The last chunk may be shorter than chunk_rows (rounding waste is
    capacity at the HBM edge); slices into and straddling it stay
    bit-exact, and extend_to restores the uniform-routing invariant."""
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
    )

    rng = np.random.default_rng(7)
    store = ChunkedPackedStore.zeros(2816, 1024)
    assert [int(c.shape[0]) for c in store.chunks] == [1024, 1024, 768]
    assert store.shape[0] == 2816
    flat = rng.integers(0, 2**32, (2816, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store.set_rows(0, flat)
    for at, w in ((2048, 768), (1920, 768), (0, 512), (2816 - 256, 256)):
        got = np.asarray(store.slice_rows(at, w))
        assert np.array_equal(got, flat[at : at + w]), (at, w)
    store.extend_to(4096)
    assert [int(c.shape[0]) for c in store.chunks] == [1024] * 4
    got = np.asarray(store.slice_rows(1920, 896))
    assert np.array_equal(got, flat[1920 : 1920 + 896])
    assert np.array_equal(
        np.asarray(store.slice_rows(2816, 1024)),
        np.zeros((1024, 32), np.uint32),
    )


def test_take_and_scatter_rows_across_chunks():
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
    )

    rng = np.random.default_rng(6)
    flat = rng.integers(0, 2**32, (3000, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store = ChunkedPackedStore.zeros(3000, 1024)
    store.set_rows(0, flat)
    idx = np.array([0, 1023, 1024, 2047, 2048, 2999])
    assert np.array_equal(store.take_rows(idx), flat[idx])
    rows = rng.integers(0, 2**32, (6, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store.scatter_rows(idx, rows)
    flat[idx] = rows
    assert np.array_equal(store.take_rows(idx), flat[idx])
    assert np.array_equal(
        np.asarray(store.slice_rows(1024, 1024)), flat[1024:2048]
    )


def test_chunked_split_state_matches_host():
    """SplitWindowState over a multi-chunk store: minimal windows force
    many moves on both axes, windows straddle chunk boundaries, pairs
    replay the host oracle exactly."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        SplitWindowState,
        banded_adjacency_pallas,
        split_need,
    )

    rng = np.random.default_rng(31)
    n = 3000
    packed, bounds = _random_library(n, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) > 0
    need = split_need(
        n, bounds, rows_window_rows=1, cols_window_rows=1,
        geom=_tiny_geom(),
    )
    store = _store_from_packed(packed, 1024, need)
    assert len(store.chunks) >= 4
    st = SplitWindowState(
        None, bounds, n=n, packed_dev=store,
        rows_window_rows=1, cols_window_rows=1, geom=_tiny_geom(),
    )
    assert isinstance(st.packed_dev, ChunkedPackedStore)
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)
    assert st.rebuilds_rows >= 3 and st.rebuilds >= 3


def test_chunked_windowed_state_matches_host():
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        WindowedPallasState,
        banded_adjacency_pallas,
        windowed_need,
    )

    rng = np.random.default_rng(32)
    n = 3000
    packed, bounds = _random_library(n, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) > 0
    need = windowed_need(n, bounds, geom=_tiny_geom())
    # chunk_rows must hold the resolved window: probe it first
    probe = WindowedPallasState(
        packed, bounds, geom=_tiny_geom()
    )
    cr = -(-probe.window_rows // 256) * 256
    store = _store_from_packed(packed, cr, need)
    if len(store.chunks) < 2:
        pytest.skip("window too wide for a multi-chunk store at this n")
    st = WindowedPallasState(
        None, bounds, n=n, packed_dev=store, geom=_tiny_geom()
    )
    assert isinstance(st.packed_dev, ChunkedPackedStore)
    wi, wj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, wi)
    assert np.array_equal(hj, wj)


def test_host_sourced_split_auto_chunks(monkeypatch):
    """The host-sourced (deferred h2d) path auto-chunks past the
    watermark: VDF_MAX_ALLOC_GB shrunk so 3000 rows cross it."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        SplitWindowState,
        banded_adjacency_pallas,
    )

    monkeypatch.setenv("VDF_MAX_ALLOC_GB", "0.0000001")  # ~107 bytes
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")
    rng = np.random.default_rng(33)
    n = 3000
    packed, bounds = _random_library(n, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    st = SplitWindowState(
        packed, bounds, rows_window_rows=1, cols_window_rows=1,
        geom=_tiny_geom(),
    )
    assert isinstance(st.packed_dev, ChunkedPackedStore)
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)


def test_incremental_library_chunked_identity_handoff(monkeypatch):
    """IncrementalDeviceLibrary past the watermark: chunked appends,
    zero-copy identity-order handoff into a split state, sweep parity;
    copy-on-write protects a shared state from later appends; the
    unsorted handoff raises the graceful capacity error."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        IncrementalDeviceLibrary,
        banded_adjacency_pallas,
    )

    monkeypatch.setenv("VDF_MAX_ALLOC_GB", "0.0000001")
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")
    rng = np.random.default_rng(34)
    n = 3000
    packed, bounds = _random_library(n, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)

    lib = IncrementalDeviceLibrary(capacity=n)
    assert isinstance(lib._packed, ChunkedPackedStore)
    lib.append(packed[:1100])
    lib.append(packed[1100:])
    st = lib.state(
        np.arange(n), bounds, windowed=True, split=True,
        geom=_tiny_geom(),
    )
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)

    # copy-on-write: appending after the handoff must not corrupt the
    # shared state's store
    lib.append(packed[:8])
    si2, sj2 = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si2)
    assert np.array_equal(hj, sj2)

    # non-identity order: graceful error, not an HBM-scale gather
    order = np.arange(n)
    order[:2] = order[:2][::-1]
    with pytest.raises(ValueError, match="duration-sorted"):
        lib2 = IncrementalDeviceLibrary(capacity=n)
        lib2.append(packed)
        lib2.state(order, bounds, windowed=True, geom=_tiny_geom())

    # resident (non-windowed) state cannot carry a chunked store
    with pytest.raises(ValueError, match="windowed"):
        lib3 = IncrementalDeviceLibrary(capacity=n)
        lib3.append(packed)
        lib3.state(
            np.arange(n), bounds, windowed=False, split=False,
            geom=_tiny_geom(),
        )


def test_public_search_chunked_host_sourced(monkeypatch):
    """Public ``search(backend="pallas_split")`` with the watermark
    shrunk so the host-sourced deferred upload auto-chunks: groups
    identical to the naive reference-shaped loop."""
    from vid_dup_finder_lib_tpu.search import search
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    monkeypatch.setenv("VDF_MAX_ALLOC_GB", "0.0000001")
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")
    rng = np.random.default_rng(38)
    n = 2000
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(30, 7200, n))
    for s in range(0, n - 1, max(1, n // 7)):
        # planted duplicate pairs at shared durations
        h = packed[s].copy()
        for b in rng.choice(1000, 60, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        packed[s + 1] = h
        durations[s + 1] = durations[s]
    hashes = VideoHash.many_from_packed_u32(
        packed, (f"/v/{i:05}.mp4" for i in range(n)), durations
    )
    want = search(hashes, 0.35, backend="naive")
    got = search(hashes, 0.35, backend="pallas_split")
    assert [g.duplicates for g in got] == [g.duplicates for g in want]
    assert len(want) > 0


def test_refs_search_over_chunked_library(monkeypatch):
    """Public ``search_with_references`` over a chunked device library
    (identity order): the windowed refs state slices its column windows
    across the chunks; groups replay the naive per-ref loop exactly."""
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        IncrementalDeviceLibrary,
    )
    from vid_dup_finder_lib_tpu.search import (
        Search,
        search_with_references,
    )
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    monkeypatch.setenv("VDF_MAX_ALLOC_GB", "0.0000001")
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")
    monkeypatch.setenv("VDF_REFS_WINDOWED", "1")
    monkeypatch.setenv("VDF_REFS_WINDOW_ROWS", "512")
    rng = np.random.default_rng(36)
    n, r = 3000, 40
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(100, 7200, n))
    cand_hashes = [
        VideoHash.from_packed_u32(
            packed[i], f"/v/{i:08}.mp4", int(durations[i])
        )
        for i in range(n)
    ]
    # refs: near-duplicates of random candidates at matching durations
    ref_hashes = []
    for k in range(r):
        j = int(rng.integers(0, n))
        h = packed[j].copy()
        for b in rng.choice(1000, 30, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        ref_hashes.append(
            VideoHash.from_packed_u32(h, f"/r/{k:04}.mp4", int(durations[j]))
        )

    lib = IncrementalDeviceLibrary(capacity=n)
    assert isinstance(lib._packed, ChunkedPackedStore)
    lib.append(packed)

    got = search_with_references(
        ref_hashes, cand_hashes, 0.35, device_library=lib
    )
    # oracle: the reference-semantics per-ref loop (no device library)
    s = Search(cand_hashes)
    want_matches = s.search_with_references(ref_hashes, 0.35, consume=False)
    want = {
        ref_hashes[k].src_path: sorted(m)
        for k, m in enumerate(want_matches)
        if m
    }
    got_map = {
        g.reference: sorted(g.duplicates) for g in got
    }
    assert got_map == want
    assert want  # the problem actually planted matches

    # unsorted appends past the watermark: graceful error
    lib2 = IncrementalDeviceLibrary(capacity=n)
    lib2.append(packed[::-1].copy())
    with pytest.raises(ValueError, match="duration-sorted"):
        search_with_references(
            ref_hashes, cand_hashes, 0.35, device_library=lib2,
            library_paths=[f"/v/{n - 1 - i:08}.mp4" for i in range(n)],
        )


def test_library_grow_migrates_flat_to_chunked(monkeypatch):
    """Appending past the watermark migrates the flat buffer into a
    chunked store with contents intact."""
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        IncrementalDeviceLibrary,
    )

    rng = np.random.default_rng(35)
    packed = rng.integers(0, 2**32, (3000, 32), dtype=np.uint64).astype(
        np.uint32
    )
    # watermark between the initial capacity (1024 rows = 128 KiB) and
    # the grown size
    monkeypatch.setenv("VDF_MAX_ALLOC_GB", str(256 * 1024 / 2**30))
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")
    lib = IncrementalDeviceLibrary(capacity=1024)
    assert not isinstance(lib._packed, ChunkedPackedStore)
    lib.append(packed[:1000])
    lib.append(packed[1000:])  # crosses: 3000 rows > 2048-row watermark
    assert isinstance(lib._packed, ChunkedPackedStore)
    assert np.array_equal(
        lib._packed.take_rows(np.arange(3000)), packed
    )


def test_capacity_guard_raises_clear_error(monkeypatch):
    """Past the packed-capacity budget, store creation and growth must
    raise a clear capacity error naming n and the budget, not die deep
    in the runtime."""
    import pytest

    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        ChunkedPackedStore,
        check_packed_capacity,
    )

    # 4096 rows * 128 B = 512 KiB cap
    monkeypatch.setenv("VDF_PACKED_CAP_GB", str(4096 * 128 / 1e9))
    monkeypatch.setenv("VDF_CHUNK_ROWS", "1024")

    check_packed_capacity(4096)  # at the cap: fine
    with pytest.raises(ValueError, match="capacity budget"):
        check_packed_capacity(5000)

    with pytest.raises(ValueError, match="5,120"):
        ChunkedPackedStore.zeros(5120, chunk_rows=1024)

    store = ChunkedPackedStore.zeros(2048, chunk_rows=1024)
    store.extend_to(4096)  # within cap
    with pytest.raises(ValueError, match="capacity budget"):
        store.extend_to(8192)
    assert store.shape[0] == 4096  # growth refused atomically


def test_take_rows_gather_oom_falls_back_to_row_slices(monkeypatch):
    """Near the HBM ceiling the batched ``jnp.take`` gather can be
    RESOURCE_EXHAUSTED even though the store itself fits (measured at
    100M hashes: 12.8 GB packed leaves no gather scratch).  take_rows
    must degrade to per-row dynamic_slice fetches, bit-exactly."""
    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(11)
    flat = rng.integers(0, 2**32, (3000, 32), dtype=np.uint64).astype(
        np.uint32
    )
    store = hp.ChunkedPackedStore.zeros(3000, 1024)
    store.set_rows(0, flat)

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: device backend error")

    monkeypatch.setattr(jnp, "take", boom)
    idx = np.array([5, 1023, 1024, 2047, 2048, 2999, 0])
    assert np.array_equal(store.take_rows(idx), flat[idx])

    def other(*a, **k):
        raise RuntimeError("INVALID_ARGUMENT: something else")

    monkeypatch.setattr(jnp, "take", other)
    with pytest.raises(RuntimeError, match="something else"):
        store.take_rows(idx)
