"""The two-phase sweep driver (counts + hit repack) against the host.

The driver sweeps counts-only and re-packs hit tiles (phase B); it must
reproduce the host backend pair-for-pair, and the phase-B word-capacity
overflow must fall back to exact host extraction.
"""

import numpy as np

from tests.test_windowed import _random_library


def _host(packed, bounds, tol):
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host

    return banded_adjacency_host(packed, bounds, tol)


def test_two_phase_matches_onepass_and_host(monkeypatch):
    """The two-phase sweep is pair-identical to the host sweep, at two
    tolerances (the name is kept from when a one-pass driver existed)."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(21)
    packed, bounds = _random_library(900, rng)
    for tol in (350, 480):
        hi, hj = _host(packed, bounds, tol)
        assert len(hi) > 0
        ti, tj = hp.banded_adjacency_pallas(packed, bounds, tol)
        assert np.array_equal(hi, ti)
        assert np.array_equal(hj, tj)


def test_phase_b_word_capacity_overflow_falls_back(monkeypatch):
    """A dense all-duplicates cluster overflows a tiny word cap; the
    per-launch host fallback must still produce exact pairs."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(33)
    n = 300
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    seed[-1] &= np.uint32(0xFF)
    packed = np.empty((n, 32), np.uint32)
    for k in range(n):
        h = seed.copy()
        for b in rng.choice(1000, 40, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        packed[k] = h
    bounds = np.full(n, n, dtype=np.int64)  # equal durations: full band

    hi, hj = _host(packed, bounds, 350)
    assert len(hi) > 1000  # dense: far more words than the tiny cap

    monkeypatch.setattr(hp, "EXTRACT_WORD_CAP", 8)
    hp._build_phase_b.cache_clear()
    try:
        ti, tj = hp.banded_adjacency_pallas(packed, bounds, 350)
    finally:
        hp._build_phase_b.cache_clear()
    assert np.array_equal(hi, ti)
    assert np.array_equal(hj, tj)


def test_phase_b_v2_hot_row_overflow_falls_back(monkeypatch):
    """V2 extraction: when the nonzero-row count exceeds the hot-row
    gather capacity, the inflated total must force the exact per-launch
    fallback (missed words would otherwise be silently dropped)."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    rng = np.random.default_rng(34)
    n = 300
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    seed[-1] &= np.uint32(0xFF)
    packed = np.empty((n, 32), np.uint32)
    for k in range(n):
        h = seed.copy()
        for b in rng.choice(1000, 40, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        packed[k] = h
    bounds = np.full(n, n, dtype=np.int64)

    hi, hj = _host(packed, bounds, 350)
    assert len(hi) > 1000

    monkeypatch.setattr(hp, "PHASE_B_V2", True)
    monkeypatch.setattr(hp, "PHASE_B_HOT_ROWS", 1)  # forces hot overflow
    hp._build_phase_b.cache_clear()
    try:
        ti, tj = hp.banded_adjacency_pallas(packed, bounds, 350)
    finally:
        hp._build_phase_b.cache_clear()
    assert np.array_equal(hi, ti)
    assert np.array_equal(hj, tj)


def test_per_tile_phase_b_matches_host(monkeypatch):
    """VDF_PHASE_B_PER_TILE=1: per-(row tile, col tile) counts + a
    BAND_TILES=1 phase-B repack geometry must stay pair-exact — on both
    a sparse library and a dense duplicate cluster (where the knob's
    narrower re-runs actually matter)."""
    from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

    monkeypatch.setenv("VDF_PHASE_B_PER_TILE", "1")

    rng = np.random.default_rng(55)
    packed, bounds = _random_library(900, rng)
    hi, hj = _host(packed, bounds, 350)
    assert len(hi) > 0
    ti, tj = hp.banded_adjacency_pallas(packed, bounds, 350)
    assert np.array_equal(hi, ti)
    assert np.array_equal(hj, tj)

    # dense cluster: 80 near-identical rows in a full band
    n = 300
    seed = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
    seed[-1] &= np.uint32(0xFF)
    dense = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    dense[:, -1] &= np.uint32(0xFF)
    for k in range(100, 180):
        h = seed.copy()
        for b in rng.choice(1000, 40, replace=False):
            h[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
        dense[k] = h
    dbounds = np.full(n, n, dtype=np.int64)
    hi2, hj2 = _host(dense, dbounds, 350)
    assert len(hi2) > 3000
    ti2, tj2 = hp.banded_adjacency_pallas(dense, dbounds, 350)
    assert np.array_equal(hi2, ti2)
    assert np.array_equal(hj2, tj2)
