"""Application-layer tests: arg parsing, disjoint set, match db,
resolution engine, and the full CLI against fixture videos (the reference's
CI runs the actual CLI and checks the JSON output has 2 groups,
.github/workflows/build.yaml:39-45)."""

import json
import os
import subprocess
import sys

import pytest

from vid_dup_finder_lib_tpu.app.arg_parse import (
    expand_args_file,
    parse_args,
    strip_comments,
)
from vid_dup_finder_lib_tpu.app.disjoint_set import DisjointSet
from vid_dup_finder_lib_tpu.app.match_db import MatchDb
from vid_dup_finder_lib_tpu.app.resolution_thunk import ResolutionThunk
from vid_dup_finder_lib_tpu.definitions import Cropdetect
from vid_dup_finder_lib_tpu.match_group import MatchGroup

from .fixtures import make_fixture_videos

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module")
def vids():
    return make_fixture_videos(DATA_DIR)


# -- arg parsing ---------------------------------------------------------------


def test_parse_defaults(tmp_path):
    d = tmp_path / "v"
    d.mkdir()
    cfg = parse_args(["--files", str(d)])
    assert cfg.tolerance == 0.3  # CLI default, NOT the library's 0.35
    assert cfg.hash_cfg.cropdetect is Cropdetect.NONE  # CLI default
    assert cfg.dir_cfg.cand_dirs == (str(d),)
    assert ".png" not in cfg.dir_cfg.excl_exts  # stored without dots here
    assert "png" in cfg.dir_cfg.excl_exts
    assert cfg.output_cfg.text.kind == "dups"


def test_parse_args_file(tmp_path):
    d = tmp_path / "v"
    d.mkdir()
    f = tmp_path / "args.txt"
    f.write_text(
        f"# a comment\n--files {d}  # trailing comment\n--tolerance 0.5\n"
    )
    cfg = parse_args(["--args-file", str(f)])
    assert cfg.tolerance == 0.5
    assert cfg.dir_cfg.cand_dirs == (str(d),)


def test_strip_comments():
    assert strip_comments("a # b\nc") == "a \nc"
    assert expand_args_file(["--tolerance", "0.2"]) == ["--tolerance", "0.2"]


# -- disjoint set (port of disjoint_set.rs:217-335) ------------------------------


def test_disjoint_set_basic():
    ds = DisjointSet()
    ds.insert_pair("a", "b")
    ds.insert_pair("c", "d")
    assert ds.same_group("a", "b")
    assert not ds.same_group("a", "c")
    assert len(ds) == 2
    ds.insert_pair("b", "c")  # merge
    assert ds.same_group("a", "d")
    assert len(ds) == 1
    assert ds.group_of("a") == frozenset({"a", "b", "c", "d"})


def test_disjoint_set_remove():
    ds = DisjointSet()
    ds.insert_group(["a", "b", "c"])
    assert ds.remove("b")
    assert ds.same_group("a", "c")
    assert not ds.contains("b")
    assert ds.remove("a")  # leaves a singleton -> group dissolves
    assert not ds.contains("c")
    assert len(ds) == 0
    assert not ds.remove("zz")


def test_disjoint_set_rename():
    ds = DisjointSet()
    ds.insert_pair("a", "b")
    assert ds.rename("a", "a2")
    assert ds.same_group("a2", "b")
    assert not ds.contains("a")


# -- match db -----------------------------------------------------------------------


def test_match_db_roundtrip(tmp_path):
    db = MatchDb(tmp_path / "db")
    db.insert_confirmed_group(["/x/a", "/x/b", "/x/c"])
    db.insert_falsepos_pair("/x/a", "/y/q")
    db.to_disk()

    db2 = MatchDb.from_disk(tmp_path / "db")
    assert db2.is_confirmed("/x/a", "/x/c")
    assert not db2.is_confirmed("/x/a", "/y/q")
    assert db2.is_falsepos("/y/q", "/x/a")  # symmetric
    groups = list(db2.confirmed_groups())
    assert len(groups) == 1 and len(groups[0]) == 3

    # saving again creates a .bak
    db2.to_disk()
    baks = [f for f in os.listdir(tmp_path / "db") if ".bak" in f]
    assert baks


def test_match_db_validation_failures(tmp_path):
    db = MatchDb(tmp_path / "db")
    db.insert_confirmed_pair("/a", "/b")
    db.insert_falsepos_pair("/a", "/b")
    assert db.confirmed_and_falsepos_entries() == [("/a", "/b")]


def test_match_db_fix_moved_files(tmp_path):
    old = tmp_path / "old.bin"
    old.write_bytes(b"same-content")
    db = MatchDb(tmp_path / "db")
    db.insert_confirmed_pair(str(old), str(tmp_path / "other.bin"))
    (tmp_path / "other.bin").write_bytes(b"other")
    # re-fetch content hashes now that files exist
    db.insert_confirmed_pair(str(old), str(tmp_path / "other.bin"))
    new = tmp_path / "moved" / "new.bin"
    new.parent.mkdir()
    old.rename(new)
    fixed = db.fix_moved_files([str(new), str(tmp_path / "other.bin")])
    assert fixed == 1
    assert db.is_confirmed(str(new), str(tmp_path / "other.bin"))


def test_match_db_manual_inputs(tmp_path):
    manual = tmp_path / "manual_inputs"
    (manual / "confirmed").mkdir(parents=True)
    (manual / "falsepos").mkdir()
    idx = [
        {"idx": 0, "matchset": ["/v/a", "/v/b"]},
        {"idx": 1, "matchset": ["/v/c", "/v/d"]},
    ]
    (manual / "idx.json").write_text(json.dumps(idx))
    (manual / "confirmed" / "0").write_text("")
    (manual / "falsepos" / "1").write_text("")
    db = MatchDb(tmp_path / "db")
    assert db.update_from_raw_parts(str(manual)) == 2
    assert db.is_confirmed("/v/a", "/v/b")
    assert db.is_falsepos("/v/c", "/v/d")


# -- resolution engine ----------------------------------------------------------------


def test_resolution_keep_and_trash(tmp_path):
    a = tmp_path / "a.mp4"
    b = tmp_path / "b.mp4"
    a.write_bytes(b"AAA")
    b.write_bytes(b"BBB")
    group = MatchGroup.new([str(a), str(b)])
    thunk = ResolutionThunk.from_matchgroup(
        group, trash_dir=str(tmp_path / "trash")
    )
    log = thunk.resolve("0")
    assert a.exists() and not b.exists()
    assert (tmp_path / "trash" / "b.mp4").exists()
    assert any("trashed" in line for line in log)
    # untrash
    thunk.resolve("u1")
    assert b.exists()


def test_resolution_as_at(tmp_path):
    d1 = tmp_path / "d1"
    d2 = tmp_path / "d2"
    d1.mkdir()
    d2.mkdir()
    a = d1 / "a.mp4"
    b = d2 / "b.mp4"
    a.write_bytes(b"AAA")
    b.write_bytes(b"BBB")
    thunk = ResolutionThunk.from_matchgroup(
        MatchGroup.new([str(a), str(b)]),
        trash_dir=str(tmp_path / "trash"),
    )
    thunk.resolve("0 as 1 at 1")  # keep a, named b.mp4, in d2
    assert (d2 / "b.mp4 (1)" == d2 / "b.mp4 (1)")  # placeholder
    # b was trashed first, so the name b.mp4 in d2 is free
    assert (d2 / "b.mp4").exists()
    assert not a.exists()


def test_resolution_rejects_garbage(tmp_path):
    a = tmp_path / "a"
    a.write_bytes(b"x")
    thunk = ResolutionThunk(entries=[str(a)])
    with pytest.raises(ValueError):
        thunk.resolve("keep the first one")
    with pytest.raises(ValueError):
        thunk.resolve("7")


# -- full CLI -------------------------------------------------------------------------


def _run_cli(args, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    return subprocess.run(
        [sys.executable, "-m", "vid_dup_finder_lib_tpu.app", *args],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )


@pytest.mark.slow
def test_cli_end_to_end_json(tmp_path, vids):
    cache_file = tmp_path / "cache.json"
    r = _run_cli(
        [
            "--files", DATA_DIR,
            "--cache-file", str(cache_file),
            "--cropdetect", "letterbox",
            "--output-format", "json",
        ],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    groups = json.loads(r.stdout)
    assert len(groups) == 2  # the reference CI's jq length check
    assert sorted(len(g["duplicates"]) for g in groups) == [3, 3]

    # cached second run: --no-update-cache, unique output
    r2 = _run_cli(
        [
            "--files", DATA_DIR,
            "--cache-file", str(cache_file),
            "--cropdetect", "letterbox",
            "--no-update-cache",
            "--output", "unique",
        ],
        tmp_path,
    )
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout.strip() == ""  # every fixture video is a duplicate

    # thumbnails
    thumbs = tmp_path / "thumbs"
    r3 = _run_cli(
        [
            "--files", DATA_DIR,
            "--cache-file", str(cache_file),
            "--cropdetect", "letterbox",
            "--no-update-cache",
            "--match-thumbnails-dir", str(thumbs),
        ],
        tmp_path,
    )
    assert r3.returncode == 0, r3.stderr
    assert (thumbs / "idx.json").exists()
    assert (thumbs / "0.jpg").exists() and (thumbs / "1.jpg").exists()


@pytest.mark.slow
def test_cli_with_refs(tmp_path, vids):
    """--with-refs end to end: cat.1 as the reference finds the other two
    cat variants among the candidates."""
    import shutil

    refs = tmp_path / "refs"
    cands = tmp_path / "cands"
    refs.mkdir()
    cands.mkdir()
    shutil.copy(vids[0], refs / "cat.1.mp4")
    for v in vids[1:]:
        shutil.copy(v, cands / os.path.basename(v))

    r = _run_cli(
        [
            "--files", str(cands),
            "--with-refs", str(refs),
            "--cache-file", str(tmp_path / "cache.json"),
            "--cropdetect", "letterbox",
            "--output-format", "json",
        ],
        tmp_path,
    )
    assert r.returncode == 0, r.stderr
    groups = json.loads(r.stdout)
    assert len(groups) == 1
    assert groups[0]["reference"].endswith("refs/cat.1.mp4")
    assert sorted(
        os.path.basename(p) for p in groups[0]["duplicates"]
    ) == ["cat.2.mp4", "cat.3.mp4"]
