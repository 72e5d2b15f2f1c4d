"""Windowed references-vs-candidates search (round-3 VERDICT item 3).

``WindowedRefsState`` keeps the refs rows resident while a +/-1 COLUMN
window slides over the device-resident packed candidate library — the
refs-path analog of ``WindowedPallasState``.  These tests pin:

* pair-level exactness vs the XLA windowed-adjacency oracle across
  window sizes (multi-window, dense duplicate clusters, pad refs tiles,
  empty per-ref windows),
* the phase-B extraction-overflow fallback with refs-space (column)
  window anchors,
* output-identity of ``search_with_references_batched`` through the
  windowed path — host-sourced and resident-library — against the
  reference-semantics per-ref loop (video_dup_finder.rs:19-46).
"""

import importlib

import numpy as np
import pytest

from vid_dup_finder_lib_tpu import platform
from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp
from vid_dup_finder_lib_tpu.ops.hamming import windowed_adjacency_device
from vid_dup_finder_lib_tpu.video_hash import VideoHash

GEOM = hp.Geometry(tile_m=128, tile_n=256, r_tiles=1, band_tiles=2)


def _refs_problem(rng, n=2048, r=333, span=900):
    cands = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    cands[1000:1100] = cands[1000]  # dense duplicate cluster
    refs = rng.integers(0, 2**32, (r, 32), dtype=np.uint64).astype(
        np.uint32
    )
    lo = np.sort(rng.integers(0, n - span, r)).astype(np.int64)
    hi = np.minimum(lo + span, n).astype(np.int64)
    hi[::11] = lo[::11]  # empty per-ref windows
    for k in range(0, r, 3):
        if hi[k] <= lo[k]:
            continue
        j = int(rng.integers(lo[k], hi[k]))
        refs[k] = cands[j]
        refs[k, rng.integers(0, 32)] ^= 1 << int(rng.integers(0, 32))
    # one ref overlapping the dense cluster
    refs[50] = cands[1000]
    lo[50], hi[50] = 900, 1200
    return cands, refs, lo, hi


def _oracle(refs, cands, lo, hi, tol):
    ei, ej = windowed_adjacency_device(refs, cands, lo, hi, tol)
    order = np.lexsort((ej, ei))
    return ei[order], ej[order]


@pytest.mark.parametrize("window_rows", [512, 1024, None])
def test_refs_windowed_pairs_exact(window_rows):
    rng = np.random.default_rng(11)
    cands, refs, lo, hi = _refs_problem(rng)
    tol = 300
    ei, ej = _oracle(refs, cands, lo, hi, tol)
    assert len(ei) > 300  # planted near-dups + the cluster ref
    ii, jj = hp.refs_adjacency_windowed(
        refs, lo, hi, tol, cands_packed=cands,
        window_rows=window_rows, geom=GEOM,
    )
    assert np.array_equal(ii, ei)
    assert np.array_equal(jj, ej)


def test_refs_windowed_overflow_fallback(monkeypatch):
    """A tiny extraction cap forces the per-launch host fallback, whose
    window anchor must be COLUMN-based for rows-static states."""
    monkeypatch.setattr(hp, "EXTRACT_WORD_CAP", 64)
    monkeypatch.setattr(hp, "PHASE_B_HOT_ROWS", 8)
    hp._build_phase_b.cache_clear()
    try:
        rng = np.random.default_rng(13)
        cands, refs, lo, hi = _refs_problem(rng)
        tol = 300
        ei, ej = _oracle(refs, cands, lo, hi, tol)
        ii, jj = hp.refs_adjacency_windowed(
            refs, lo, hi, tol, cands_packed=cands,
            window_rows=512, geom=GEOM,
        )
        assert np.array_equal(ii, ei)
        assert np.array_equal(jj, ej)
    finally:
        hp._build_phase_b.cache_clear()


def test_refs_windowed_resident_cands():
    """Device-resident candidates (IncrementalDeviceLibrary rows): the
    [cands | pad] device assembly must equal the host-sourced path."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    cands, refs, lo, hi = _refs_problem(rng, n=1024, r=100, span=400)
    tol = 300
    ei, ej = _oracle(refs, cands, lo, hi, tol)
    ii, jj = hp.refs_adjacency_windowed(
        refs, lo, hi, tol,
        cands_dev=jnp.asarray(cands), n_cands=cands.shape[0],
        window_rows=512, geom=GEOM,
    )
    assert np.array_equal(ii, ei)
    assert np.array_equal(jj, ej)


def _named(hashes):
    return [
        h.with_src_path(f"/v/{i:04}") for i, h in enumerate(hashes)
    ]


def _ref_loop_expected(Search, cands, refs, tol):
    s1 = Search(cands)
    return [
        s1.search_with_references([r], tol, consume=False)[0]
        for r in refs
    ]


def _make_cands_refs(rng, n=500, r=150):
    cands = _named([VideoHash.random_hash(rng) for _ in range(n)])
    cands = [
        h.with_duration(int(d))
        for h, d in zip(cands, rng.integers(50, 500, n))
    ]
    refs = [
        VideoHash.random_hash(rng)
        .with_src_path(f"/r/{i:03}")
        .with_duration(int(d))
        for i, d in enumerate(rng.integers(50, 500, r))
    ]
    refs[5] = cands[17].with_src_path("/r/005")
    refs[90] = (
        cands[300]
        .hash_with_spatial_distance(100, rng)
        .with_src_path("/r/090")
        .with_duration(cands[300].duration)
    )
    return cands, refs


def test_search_with_references_windowed_matches_loop(monkeypatch):
    """The windowed refs path (forced) is output-identical to the
    reference-semantics per-ref loop."""
    search_mod = importlib.import_module("vid_dup_finder_lib_tpu.search")
    Search = search_mod.Search
    monkeypatch.setattr(search_mod, "_DEVICE_REFS_WORK_THRESHOLD", 0)
    monkeypatch.setattr(platform, "device_sweep", lambda: True)
    monkeypatch.setenv("VDF_REFS_WINDOWED", "1")

    rng = np.random.default_rng(31)
    cands, refs = _make_cands_refs(rng)
    tol = 0.47
    expected = _ref_loop_expected(Search, cands, refs, tol)
    got = Search(cands).search_with_references_batched(refs, tol)
    assert got == expected
    assert any(expected)


def test_search_with_references_windowed_resident(monkeypatch):
    """Resident-library (attach_device_library) + windowed refs path."""
    search_mod = importlib.import_module("vid_dup_finder_lib_tpu.search")
    Search = search_mod.Search
    monkeypatch.setenv("VDF_REFS_WINDOWED", "1")

    rng = np.random.default_rng(37)
    cands, refs = _make_cands_refs(rng)
    tol = 0.47
    expected = _ref_loop_expected(Search, cands, refs, tol)

    lib = hp.IncrementalDeviceLibrary()
    paths = [h.src_path for h in cands]
    lib.append(np.stack([h.packed_u32() for h in cands]))
    s = Search(cands)
    s.attach_device_library(lib, paths)
    got = s.search_with_references_batched(refs, tol)
    assert got == expected
    assert any(expected)
