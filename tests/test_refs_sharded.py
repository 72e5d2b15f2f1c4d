"""Multi-chip refs search: refs sharded over the 8-device CPU mesh.

``refs_adjacency_sharded`` (parallel/refs_sharded.py) splits duration-
sorted refs contiguously over the mesh, replicates the packed candidate
library, and slides a per-shard +/-1 column window over each shard's
band slab — zero collectives in the hot loop.  Pinned here: pair-level
exactness vs the XLA oracle across window sizes, the extraction-
overflow host fallback, and output-identity through
``search_with_references_batched`` (video_dup_finder.rs:19-46).
"""

import importlib

import numpy as np
import pytest

from vid_dup_finder_lib_tpu import platform
from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp
from vid_dup_finder_lib_tpu.ops.hamming import windowed_adjacency_device
from vid_dup_finder_lib_tpu.parallel import ring_pallas as rp
from vid_dup_finder_lib_tpu.parallel.mesh import make_mesh
from vid_dup_finder_lib_tpu.parallel.refs_sharded import (
    refs_adjacency_sharded,
)

from tests.test_refs_windowed import GEOM, _make_cands_refs, _refs_problem


def _oracle(refs, cands, lo, hi, tol):
    ei, ej = windowed_adjacency_device(refs, cands, lo, hi, tol)
    order = np.lexsort((ej, ei))
    return ei[order], ej[order]


@pytest.mark.parametrize("window_rows", [512, None])
def test_refs_sharded_pairs_exact(window_rows):
    rng = np.random.default_rng(11)
    cands, refs, lo, hi = _refs_problem(rng)
    tol = 300
    ei, ej = _oracle(refs, cands, lo, hi, tol)
    assert len(ei) > 300
    mesh = make_mesh(8)
    ii, jj = refs_adjacency_sharded(
        refs, lo, hi, tol, cands_packed=cands, mesh=mesh,
        window_rows=window_rows, geom=GEOM,
    )
    assert np.array_equal(ii, ei)
    assert np.array_equal(jj, ej)


def test_refs_sharded_overflow_fallback(monkeypatch):
    """A tiny per-shard extraction cap forces the exact host recompute
    of overflowing batches."""
    monkeypatch.setattr(rp, "RING_EXTRACT_CAP", 64)
    rp._ring_jits.cache_clear()
    try:
        rng = np.random.default_rng(13)
        cands, refs, lo, hi = _refs_problem(rng)
        tol = 300
        ei, ej = _oracle(refs, cands, lo, hi, tol)
        mesh = make_mesh(8)
        ii, jj = refs_adjacency_sharded(
            refs, lo, hi, tol, cands_packed=cands, mesh=mesh,
            window_rows=512, geom=GEOM,
        )
        assert np.array_equal(ii, ei)
        assert np.array_equal(jj, ej)
    finally:
        rp._ring_jits.cache_clear()


def test_search_with_references_sharded_matches_loop(monkeypatch):
    """The sharded refs backend (forced) is output-identical to the
    reference-semantics per-ref loop through the public batched API."""
    search_mod = importlib.import_module("vid_dup_finder_lib_tpu.search")
    Search = search_mod.Search
    monkeypatch.setattr(search_mod, "_DEVICE_REFS_WORK_THRESHOLD", 0)
    monkeypatch.setattr(platform, "device_sweep", lambda: True)
    monkeypatch.setenv("VDF_REFS_WINDOWED", "1")
    monkeypatch.setenv("VDF_REFS_SHARDED", "1")

    rng = np.random.default_rng(41)
    cands, refs = _make_cands_refs(rng)
    tol = 0.47
    s1 = Search(cands)
    expected = [
        s1.search_with_references([r], tol, consume=False)[0]
        for r in refs
    ]
    got = Search(cands).search_with_references_batched(refs, tol)
    assert got == expected
    assert any(expected)
