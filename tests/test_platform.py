"""The platform decision, device budgets, compile-cache placement, routing
on a GPU, and the Triton sweep launches (interpret mode) against the plain
launch and the host sweep."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vid_dup_finder_lib_tpu import platform
from vid_dup_finder_lib_tpu.ops import hamming
from vid_dup_finder_lib_tpu.ops import hamming_pallas as hp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = hp.Geometry(tile_m=128, tile_n=256, r_tiles=1, band_tiles=2)


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _fake_gpu(monkeypatch, stats=None):
    """Make the platform module see a GPU with ``stats`` as its
    memory_stats (nothing is run on it)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])


# -- the platform module ------------------------------------------------------


@pytest.mark.parametrize(
    "name, expect", [("gpu", "gpu"), ("cpu", "cpu"), ("rocm", None)]
)
def test_backend_outcomes(monkeypatch, name, expect):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    if expect is None:
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            platform.backend()
    else:
        assert platform.backend() == expect
        assert platform.device_sweep() == (expect == "gpu")
        assert platform.interpret() == (expect == "cpu")


def test_interpret_mode_raises_on_gpu(monkeypatch):
    platform.check_interpret(True)  # the CPU backend: allowed
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    platform.check_interpret(False)
    with pytest.raises(RuntimeError, match="interpret mode on a GPU"):
        platform.check_interpret(True)


def test_triton_launch_refuses_interpret_on_gpu(monkeypatch):
    """A GPU never picks interpret mode: the builder asks the platform,
    and forcing interpret there raises."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(platform, "interpret", lambda: True)
    with pytest.raises(RuntimeError, match="interpret mode on a GPU"):
        hp._triton_launch(TINY, "pack")


def test_sweep_launch_choice(monkeypatch):
    assert hp.sweep_launch() == "plain"  # the CPU backend
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert hp.sweep_launch() == "triton"


# -- budgets ------------------------------------------------------------------


def test_budgets_from_fake_memory_stats(monkeypatch):
    for k in ("VDF_WINDOWED_THRESHOLD", "VDF_HBM_BUDGET_GB",
              "VDF_SPLIT_BUDGET_GB", "VDF_PACKED_CAP_GB",
              "VDF_MAX_ALLOC_GB"):
        monkeypatch.delenv(k, raising=False)
    limit = 60 * 2**30
    _fake_gpu(monkeypatch, {"bytes_limit": limit})
    assert platform.bytes_limit() == limit
    # a quarter of the budget at 1024 + 128 bytes per row
    assert platform.resident_rows() == limit // 4 // 1152
    assert hp.hbm_budget_bytes() == 0.75 * limit
    assert hp._split_budget_bytes() == 0.875 * limit
    assert hp._packed_cap_bytes() == 0.7 * limit
    assert hp._max_alloc_bytes() == float("inf")  # flat store on a GPU
    # the env overrides still win
    monkeypatch.setenv("VDF_HBM_BUDGET_GB", "2")
    monkeypatch.setenv("VDF_WINDOWED_THRESHOLD", "1234")
    monkeypatch.setenv("VDF_MAX_ALLOC_GB", "1")
    assert hp.hbm_budget_bytes() == 2 * 2**30
    assert platform.resident_rows() == 1234
    assert hp._max_alloc_bytes() == 2**30


@pytest.mark.parametrize("stats", [None, {}])
def test_gpu_without_memory_stats_is_an_error(monkeypatch, stats):
    _fake_gpu(monkeypatch, stats)
    with pytest.raises(RuntimeError, match="bytes_limit"):
        platform.bytes_limit()


def test_cpu_budget_is_the_named_test_default(monkeypatch):
    monkeypatch.delenv("VDF_HBM_BUDGET_GB", raising=False)
    assert platform.bytes_limit() == platform.CPU_TEST_BYTES_LIMIT
    assert hp.hbm_budget_bytes() == 0.75 * platform.CPU_TEST_BYTES_LIMIT


# -- compile cache ------------------------------------------------------------


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_placement(monkeypatch, env_dir):
    from vid_dup_finder_lib_tpu.utils import jaxconfig

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    updates = {}
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: updates.__setitem__(k, v)
    )
    monkeypatch.setattr(os, "makedirs", lambda *a, **k: None)
    jaxconfig.enable_compilation_cache()
    if env_dir is None:
        want = os.path.join(REPO, ".jax_cache")
        assert jaxconfig.cache_dir() == want
        assert updates["jax_compilation_cache_dir"] == want
    else:
        assert jaxconfig.cache_dir() is None
        assert "jax_compilation_cache_dir" not in updates


# -- routing on a GPU ---------------------------------------------------------


def _library(n, rng):
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    durs = np.sort(rng.integers(50, 200, n))
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), "right")
    return packed, bounds


@pytest.mark.parametrize(
    "threshold, ring_min, want",
    [
        ("1000000", "1000000", "resident"),
        ("100", "1000000", "windowed"),
        ("1000000", "64", "ring"),
    ],
)
def test_auto_routing_on_gpu(monkeypatch, threshold, ring_min, want):
    """``auto`` on a GPU takes the two-phase sweep states (resident,
    windowed) or the ring; the route is asserted, not run."""
    from vid_dup_finder_lib_tpu.parallel import ring_pallas

    packed, bounds = _library(300, np.random.default_rng(1))
    taken = []
    monkeypatch.setattr(platform, "device_sweep", lambda: True)
    monkeypatch.setenv("VDF_WINDOWED_THRESHOLD", threshold)
    monkeypatch.setenv("VDF_RING_MIN_N", ring_min)
    monkeypatch.setenv("VDF_FORCE_SPLIT", "0")
    monkeypatch.setattr(
        hp, "banded_adjacency_pallas",
        lambda p, b, t, state=None: taken.append(
            "resident" if state is None else type(state).__name__
        ) or (np.zeros(0, np.int64),) * 2,
    )
    monkeypatch.setattr(
        ring_pallas, "banded_adjacency_ring",
        lambda p, b, t: taken.append("ring") or (np.zeros(0, np.int64),) * 2,
    )
    hamming.banded_adjacency(packed, bounds, 350, backend="auto")
    assert taken == [
        {"windowed": "WindowedPallasState"}.get(want, want)
    ]


def test_refs_routing_on_gpu(monkeypatch):
    """Batched references search takes the device sweep on a GPU."""
    from vid_dup_finder_lib_tpu.search import Search
    from vid_dup_finder_lib_tpu.video_hash import VideoHash

    rng = np.random.default_rng(2)
    cands = [
        VideoHash.random_hash(rng).with_src_path(f"/c/{i:04d}")
        .with_duration(100 + i % 7)
        for i in range(200)
    ]
    refs = [
        cands[i].with_src_path(f"/r/{i:04d}") for i in range(0, 200, 2)
    ]
    calls = []
    monkeypatch.setattr(platform, "device_sweep", lambda: True)
    monkeypatch.setattr(
        hp, "refs_adjacency_pallas",
        lambda *a, **k: calls.append(len(a[0]))
        or (np.zeros(0, np.int64),) * 2,
    )
    import importlib

    search_mod = importlib.import_module("vid_dup_finder_lib_tpu.search")
    monkeypatch.setattr(search_mod, "_DEVICE_REFS_WORK_THRESHOLD", 1)
    Search(cands).search_with_references_batched(refs, 0.35)
    assert calls == [len(refs)]


def test_device_error_in_auto_propagates(monkeypatch):
    """No silent host rerun: a device failure in ``auto`` surfaces."""
    packed, bounds = _library(200, np.random.default_rng(3))
    monkeypatch.setattr(platform, "device_sweep", lambda: True)

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(hp, "banded_adjacency_pallas", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        hamming.banded_adjacency(packed, bounds, 350, backend="auto")


# -- the Triton launches (interpret mode) -------------------------------------


def _launch_problem(seed, row_base):
    """Operands + 3 launch scalar vectors at TINY geometry, with planted
    near-duplicates; ``row_base`` -1 reads per-row lower bounds from the
    row_lo operand (the refs layout)."""
    rng = np.random.default_rng(seed)
    n_pad = 8 * TINY.tile_m
    pm = rng.choice(np.array([-1, 1], np.int8), (n_pad, 1024))
    for a, b in ((5, 300), (130, 140), (260, 700), (400, 401)):
        pm[b] = pm[a]
        pm[b, : 20 + a % 50] *= -1
    n = n_pad - 3 * TINY.tile_n
    bounds = np.full((n_pad, 1), -1, np.int32)
    bounds[:n, 0] = np.minimum(np.arange(n) + 600, n)
    row_lo = np.full((n_pad, 1), hp._ROW_LO_SENTINEL, np.int32)
    row_lo[:n, 0] = np.maximum(np.arange(n) - 200, -1)
    scal = np.array(
        [[350, n, rt, ct, 0, 0, 0, row_base]
         for rt, ct in ((0, 0), (1, 0), (3, 2))],
        np.int32,
    )
    return (jnp.asarray(scal), jnp.asarray(pm), jnp.asarray(bounds),
            jnp.asarray(row_lo))


def _host_launch(scal, pm, bounds, row_lo):
    """NumPy reference of one launch: int32[BAND] per-tile counts and the
    [BAND, TILE_M//32, TILE_N] packed words."""
    tm, tn, _, band = TINY
    tol, n, rt, ct, _, _, wbase, row_base = (int(v) for v in scal)
    a = pm[rt * tm:(rt + 1) * tm].astype(np.int32)
    b = pm[ct * tn:(ct + band) * tn].astype(np.int32)
    cols = (ct + wbase) * tn + np.arange(band * tn)[None, :]
    rows = (row_base + rt) * tm + np.arange(tm)[:, None]
    rlo = rows if row_base >= 0 else row_lo[rt * tm:(rt + 1) * tm]
    lim = np.minimum(bounds[rt * tm:(rt + 1) * tm], n)
    adj = (a @ b.T >= 1024 - 2 * tol) & (cols > rlo) & (cols < lim)
    bits = adj.reshape(tm // 32, 32, band, tn).astype(np.uint64)
    words = (bits << np.arange(32, dtype=np.uint64)[None, :, None, None]
             ).sum(axis=1).astype(np.uint32).view(np.int32)
    return adj.reshape(tm, band, tn).sum(axis=(0, 2)), words.transpose(
        1, 0, 2)


@pytest.mark.parametrize("row_base", [0, -1])
@pytest.mark.parametrize("mode", ["pack", "counts", "tile_counts"])
def test_triton_launch_matches_plain_and_host(mode, row_base):
    scal, pm, bounds, row_lo = _launch_problem(7, row_base)
    build = {
        "pack": lambda launch: hp._build_chunk(launch, TINY),
        "counts": lambda launch: hp._build_chunk_counts(launch, TINY),
        "tile_counts": lambda launch: hp._build_chunk_counts(
            launch, TINY, True),
    }[mode]
    hits = 0
    for k in range(scal.shape[0]):
        args = (scal[k], pm, pm, bounds, row_lo)
        got = jax.tree_util.tree_map(np.asarray, build("triton")(*args))
        want = jax.tree_util.tree_map(np.asarray, build("plain")(*args))
        counts, words = _host_launch(
            np.asarray(scal[k]), np.asarray(pm), np.asarray(bounds),
            np.asarray(row_lo),
        )
        hits += int(counts.sum())
        if mode == "pack":
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[0][0], words)
            assert np.array_equal(got[1][0], counts)
        elif mode == "counts":
            assert np.array_equal(got, want)
            assert got.tolist() == [counts.sum()]
        else:
            assert np.array_equal(got, want)
            assert got.tolist() == counts.tolist()
    assert hits > 0  # the planted pairs fall inside the launches


@pytest.mark.parametrize("kind", ["resident", "windowed", "split", "refs"])
def test_sweep_states_on_triton_launch(monkeypatch, kind):
    """The two-phase driver with the Triton launch (interpret mode) is
    pair-identical to the host sweep on every state kind."""
    from vid_dup_finder_lib_tpu.ops.hamming import banded_adjacency_host

    monkeypatch.setattr(hp, "sweep_launch", lambda: "triton")
    rng = np.random.default_rng(11)
    n = 1500
    packed = rng.integers(0, 2**32, (n, 32), dtype=np.uint64).astype(
        np.uint32
    )
    packed[:, -1] &= np.uint32(0xFF)
    for a in range(0, n - 40, 97):
        packed[a + 30] = packed[a]
        packed[a + 30, 0] ^= np.uint32(0xFFFF)
    durs = np.sort(rng.integers(100, 110, n))
    bounds = np.searchsorted(durs, (durs * 1.1).astype(np.int64), "right")
    if kind == "refs":
        lo = np.maximum(np.arange(0, n, 5) - 100, 0)
        hi = np.minimum(lo + 400, n)
        refs = packed[::5].copy()
        ii, jj = hp.refs_adjacency_pallas(refs, packed, lo, hi, 350,
                                          geom=TINY)
        dist = np.bitwise_count(refs[:, None, :] ^ packed[None]).sum(2)
        cols = np.arange(n)[None, :]
        ei, ej = np.nonzero(
            (dist <= 350) & (cols >= lo[:, None]) & (cols < hi[:, None])
        )
    else:
        cls = {
            "resident": hp.PallasSearchState,
            "windowed": hp.WindowedPallasState,
            "split": hp.SplitWindowState,
        }[kind]
        st = cls(packed, bounds, geom=TINY)
        ii, jj = hp.banded_adjacency_pallas(packed, bounds, 350, state=st)
        ei, ej = banded_adjacency_host(packed, bounds, 350)
    assert len(ei) > 10
    assert np.array_equal(ii, ei) and np.array_equal(jj, ej)


@pytest.mark.gpu
def test_triton_launch_compiles_on_gpu(gpu_device):
    """On the card: the Triton launches compile at the production
    geometry and agree with the plain launch."""
    geom = hp.Geometry()
    rng = np.random.default_rng(0)
    n = 64 * geom.tile_n
    pm = jnp.asarray(rng.choice(np.array([-1, 1], np.int8), (n, 1024)))
    bounds = jnp.full((n, 1), n // 2, jnp.int32)
    scal = jnp.asarray(
        np.array([350, n // 2, 3, 3] + [0] * (geom.n_scal - 4), np.int32)
    )
    for launch in ("plain", "triton"):
        out = hp._build_chunk(launch, geom)(scal, pm, pm, bounds, bounds)
        if launch == "plain":
            want = out
    assert np.array_equal(np.asarray(out[0]), np.asarray(want[0]))


# -- chip_smoke.py ------------------------------------------------------------


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    import shutil

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(tmp_path / "chip_smoke.py")],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=tmp_path,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("rows, wide", [(1 << 20, False), (3 << 20, True)])
def test_triton_offsets_are_64_bit_past_2_gib(monkeypatch, rows, wide):
    """Lowering a Triton launch for CUDA (no GPU needed): loads from an
    int8 operand of 2-4 GiB must reach the offset helper as an array past
    2**32 bytes (64-bit offsets); smaller operands keep 32-bit offsets."""
    from jax._src.pallas.triton import lowering

    monkeypatch.setattr(platform, "interpret", lambda: False)
    seen = []
    real = lowering._compute_offsets_from_indices

    def spy(block_info, nd_indexer):
        aval = block_info.full_shape_dtype
        if aval.dtype == jnp.int8:
            seen.append(aval.size)
        return real(block_info, nd_indexer)

    monkeypatch.setattr(lowering, "_compute_offsets_from_indices", spy)
    hp._wide_triton_offsets.cache_clear()
    try:
        geom = hp.Geometry()
        pm = jax.ShapeDtypeStruct((rows, 1024), jnp.int8)
        b = jax.ShapeDtypeStruct((rows, 1), jnp.int32)
        s = jax.ShapeDtypeStruct((geom.n_scal,), jnp.int32)
        jax.jit(hp._triton_launch(geom, "tile_counts")).trace(
            s, pm, pm, b, b
        ).lower(lowering_platforms=("cuda",))
    finally:
        hp._wide_triton_offsets.cache_clear()
    assert seen
    assert all((n > 2**32) == wide for n in seen)
