"""Split-window Pallas sweep: independent rows/cols +/-1 windows.

``SplitWindowState`` lifts the single-window capacity bound (packed
matrix + the widest band span of +/-1 operands ≤ HBM) by feeding the
kernel's two operand slots from two small independent windows — a row
chunk's band may then span several cols-window positions.  These tests
pin pair-for-pair parity against the host sweep across window-move
patterns the single window can never produce, the overflow fallback,
the public search backend, and the zero-copy identity-order handoff
from ``IncrementalDeviceLibrary``.

Reference semantics being preserved: the ``search_algorithm.rs:81-185``
adjacency contract (all pairs i < j < bounds[i], hamming <= tol,
lexicographic order).
"""

import numpy as np

from tests.test_windowed import _random_library

TINY = dict(tile_m=128, tile_n=256, r_tiles=1, band_tiles=2)


def _tiny_geom():
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import Geometry

    return Geometry(**TINY)


def test_split_matches_host_default_windows():
    """Default (env-derived) window sizes at small n: both windows cap
    at the padded library — a single position each, parity exact."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        SplitWindowState,
        banded_adjacency_pallas,
    )

    rng = np.random.default_rng(21)
    packed, bounds = _random_library(700, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) > 0
    st = SplitWindowState(packed, bounds)
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)


def test_split_many_window_moves_both_axes():
    """Minimal windows at tiny tile geometry: the sweep must move BOTH
    windows many times and still reproduce the host pairs exactly."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        SplitWindowState,
        banded_adjacency_pallas,
    )

    rng = np.random.default_rng(11)
    packed, bounds = _random_library(3000, rng)
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) > 0
    st = SplitWindowState(
        packed, bounds, rows_window_rows=1, cols_window_rows=1,
        geom=_tiny_geom(),
    )
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)
    assert st.rebuilds_rows >= 3, st.rebuilds_rows
    assert st.rebuilds >= 3, st.rebuilds


def test_split_band_wider_than_cols_window():
    """The defining case: near-equal durations make every band span the
    whole library, far wider than the minimal cols window — a single
    window could never hold it (its minimum size IS the band span).
    Each row chunk's band must split across several cols-window
    positions with counts/phase-B synced at every move."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
        SplitWindowState,
        banded_adjacency_pallas,
    )

    rng = np.random.default_rng(31)
    n = 4000
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    packed[:, -1] &= np.uint32(0xFF)
    durations = np.sort(rng.integers(1000, 1050, n))  # ~full band
    for s in range(0, n - 1, n // 9):
        h = packed[s].copy()
        for b in rng.choice(1000, 60, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        packed[s + 1] = h
    bounds = np.searchsorted(
        durations,
        (durations.astype(np.float64) * 1.1).astype(np.int64),
        side="right",
    )
    assert int(bounds[0]) == n  # the band really is the whole library

    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) >= 9
    geom = _tiny_geom()
    st = SplitWindowState(
        packed, bounds, rows_window_rows=1, cols_window_rows=1, geom=geom,
    )
    # the minimal cols window is a fraction of the band span
    assert st.window_rows < n // 2
    si, sj = banded_adjacency_pallas(packed, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)
    # every rows window re-anchors the cols window several times
    assert st.rebuilds > st.rebuilds_rows >= 2, (
        st.rebuilds, st.rebuilds_rows,
    )


def test_split_overflow_fallback(monkeypatch):
    """A dense all-duplicates cluster overflows a tiny word cap; the
    split state's per-launch fallback (which re-anchors BOTH windows per
    launch) must still produce exact pairs."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host

    rng = np.random.default_rng(33)
    n = 600
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    seed[-1] &= np.uint32(0xFF)
    packed = np.empty((n, 32), np.uint32)
    for k in range(n):
        h = seed.copy()
        for b in rng.choice(1000, 40, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        packed[k] = h
    bounds = np.full(n, n, dtype=np.int64)  # equal durations: full band

    hi, hj = banded_adjacency_host(packed, bounds, 350)
    assert len(hi) > 1000

    monkeypatch.setattr(hp, "EXTRACT_WORD_CAP", 8)
    hp._build_phase_b.cache_clear()
    try:
        st = hp.SplitWindowState(
            packed, bounds, rows_window_rows=1, cols_window_rows=1,
            geom=_tiny_geom(),
        )
        ti, tj = hp.banded_adjacency_pallas(packed, bounds, 350, state=st)
    finally:
        hp._build_phase_b.cache_clear()
    assert np.array_equal(hi, ti)
    assert np.array_equal(hj, tj)


def test_split_search_groups_match_host():
    """Public API: search(backend="pallas_split") returns the same
    groups in the same order as the host backend."""
    from vid_dup_finder_lib_tpu.search import search
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    rng = np.random.default_rng(9)
    hashes = [VideoHash.random_hash(rng) for _ in range(220)]
    hashes = [
        h.with_src_path(f"/v/{i:04}").with_duration(int(d))
        for i, (h, d) in enumerate(
            zip(hashes, rng.integers(50, 400, len(hashes)))
        )
    ]
    hashes[11] = (
        hashes[10].hash_with_spatial_distance(80, rng)
        .with_src_path("/v/0011").with_duration(hashes[10].duration)
    )
    hashes[101] = (
        hashes[100].hash_with_spatial_distance(40, rng)
        .with_src_path("/v/0101").with_duration(hashes[100].duration)
    )
    expected = search(hashes, 0.3, backend="host")
    got = search(hashes, 0.3, backend="pallas_split")
    assert got == expected
    assert expected


def test_incremental_identity_order_zero_copy():
    """Rows appended pre-sorted: ``state`` hands the library buffer to
    the state zero-copy; a subsequent append must copy first (the
    donating in-place update would delete the shared buffer) and both
    the old state and the new library stay correct."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(17)
    packed, bounds = _random_library(600, rng)
    geom = _tiny_geom()
    # capacity must cover the state's `need` (padded rows + the larger
    # window) or the state pad-concats a copy instead of sharing
    lib = hp.IncrementalDeviceLibrary(
        capacity=hp.split_need(600, bounds, geom=geom)
    )
    lib.append(packed)
    st = lib.state(
        np.arange(600), bounds, windowed=True, split=True, geom=geom
    )
    assert isinstance(st, hp.SplitWindowState)
    assert st.packed_dev is lib._packed  # the zero-copy handoff
    assert lib._shared

    hi, hj = banded_adjacency_host(packed, bounds, 350)
    si, sj = hp.banded_adjacency_pallas(None, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)

    # append after the handoff: the library must copy, not donate
    lib.append(packed[:64])
    assert not lib._shared
    assert lib.n == 664
    # the old state's buffer survived the append — the sweep still runs
    si2, sj2 = hp.banded_adjacency_pallas(None, bounds, 350, state=st)
    assert np.array_equal(hi, si2)
    assert np.array_equal(hj, sj2)


def test_incremental_permuted_order_still_gathers():
    """A non-identity order takes the gather path (no sharing)."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(23)
    packed, bounds = _random_library(400, rng)
    perm = rng.permutation(400)
    lib = hp.IncrementalDeviceLibrary(capacity=1024)
    lib.append(packed[perm])  # insertion order scrambles the sort
    # order[sorted_pos] = insertion index of that row: packed[j] sits at
    # insertion slot inv_perm[j]
    order = np.empty(400, np.int64)
    order[perm] = np.arange(400)
    st = lib.state(order, bounds, windowed=True, split=True,
                   geom=_tiny_geom())
    assert not lib._shared
    hi, hj = banded_adjacency_host(packed, bounds, 350)
    si, sj = hp.banded_adjacency_pallas(None, bounds, 350, state=st)
    assert np.array_equal(hi, si)
    assert np.array_equal(hj, sj)


def test_should_split_rule(monkeypatch):
    """The auto rule keys on the single-window HBM footprint; the env
    knobs force/veto it."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(5)
    _packed, bounds = _random_library(700, rng)
    geom = _tiny_geom()
    monkeypatch.delenv("VDF_FORCE_SPLIT", raising=False)
    assert not hp.should_split(700, bounds, geom)  # tiny library fits
    monkeypatch.setenv("VDF_HBM_BUDGET_GB", "0.000001")
    assert hp.should_split(700, bounds, geom)  # budget exceeded
    monkeypatch.setenv("VDF_FORCE_SPLIT", "0")
    assert not hp.should_split(700, bounds, geom)  # veto wins
    monkeypatch.delenv("VDF_HBM_BUDGET_GB")
    monkeypatch.setenv("VDF_FORCE_SPLIT", "1")
    assert hp.should_split(700, bounds, geom)  # force wins


def test_windowed_need_matches_state():
    """Device-born generators size their buffer with ``windowed_need`` /
    ``split_need``; the states must then take the no-copy path."""
    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(7)
    packed, bounds = _random_library(900, rng)
    geom = _tiny_geom()

    need_w = hp.windowed_need(900, bounds, geom=geom)
    dev = jnp.zeros((need_w, 32), jnp.uint32).at[:900].set(
        jnp.asarray(packed)
    )
    st = hp.WindowedPallasState(None, bounds, n=900, packed_dev=dev,
                                geom=geom)
    assert st.packed_dev is dev  # no pad concat

    need_s = hp.split_need(900, bounds, geom=geom)
    dev_s = jnp.zeros((need_s, 32), jnp.uint32).at[:900].set(
        jnp.asarray(packed)
    )
    st_s = hp.SplitWindowState(None, bounds, n=900, packed_dev=dev_s,
                               geom=geom)
    assert st_s.packed_dev is dev_s


class TestAutoSplitWindowSizing:
    """Default split windows auto-shrink near the device-memory ceiling,
    so a near-ceiling library picks launchable windows instead of
    running out of memory in the counts launch."""

    ALIGN = 2048

    def _resolve(self, n, rows=None, cols=None):
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            Geometry,
            _resolve_split_windows,
        )

        n_pad = -(-n // self.ALIGN) * self.ALIGN
        return _resolve_split_windows(
            n_pad, self.ALIGN, rows, cols, Geometry()
        )

    def test_defaults_stand_at_the_measured_80m_pass(self, monkeypatch):
        monkeypatch.delenv("VDF_SPLIT_ROWS_WINDOW", raising=False)
        monkeypatch.delenv("VDF_SPLIT_COLS_WINDOW", raising=False)
        assert self._resolve(80_000_000) == (1 << 20, 1 << 21)

    def test_auto_halves_at_the_measured_96m_failure(self, monkeypatch):
        monkeypatch.delenv("VDF_SPLIT_ROWS_WINDOW", raising=False)
        monkeypatch.delenv("VDF_SPLIT_COLS_WINDOW", raising=False)
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            _split_budget_bytes,
            _split_plan_bytes,
        )

        for n in (96_000_000, 100_000_000):
            rw, cw = self._resolve(n)
            assert (rw, cw) == (1 << 19, 1 << 20)
            n_pad = -(-n // self.ALIGN) * self.ALIGN
            assert (
                _split_plan_bytes(n_pad, self.ALIGN, rw, cw)
                <= _split_budget_bytes()
            )

    def test_explicit_sizes_are_authoritative(self, monkeypatch):
        monkeypatch.delenv("VDF_SPLIT_ROWS_WINDOW", raising=False)
        monkeypatch.delenv("VDF_SPLIT_COLS_WINDOW", raising=False)
        assert self._resolve(96_000_000, 1 << 20, 1 << 21) == (
            1 << 20,
            1 << 21,
        )

    def test_env_sizes_are_authoritative(self, monkeypatch):
        monkeypatch.setenv("VDF_SPLIT_ROWS_WINDOW", str(1 << 20))
        monkeypatch.setenv("VDF_SPLIT_COLS_WINDOW", str(1 << 21))
        assert self._resolve(96_000_000) == (1 << 20, 1 << 21)

    def test_floors_hold_when_nothing_fits(self, monkeypatch):
        monkeypatch.delenv("VDF_SPLIT_ROWS_WINDOW", raising=False)
        monkeypatch.delenv("VDF_SPLIT_COLS_WINDOW", raising=False)
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import Geometry

        g = Geometry()
        min_cw = self.ALIGN + (g.band_tiles + 1) * g.tile_n
        min_cw = -(-min_cw // self.ALIGN) * self.ALIGN
        rw, cw = self._resolve(1_000_000_000)
        assert (rw, cw) == (self.ALIGN, min_cw)

    def test_fit_chunk_rows_kills_roundup_waste(self):
        from vid_dup_finder_lib_tpu.ops.hamming_pallas import (
            _default_chunk_rows,
            fit_chunk_rows,
        )

        total = 101_300_000
        cr = fit_chunk_rows(total)
        k = -(-total // cr)
        assert cr % 2048 == 0
        assert k == -(-total // _default_chunk_rows())
        assert k * cr - total < k * 2048  # waste < align per chunk
        # far below the watermark nothing changes shape-wise
        assert fit_chunk_rows(16 * 2**20) == 16 * 2**20
