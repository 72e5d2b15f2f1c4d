"""VideoHash metric properties.

Ports the reference's in-module hash tests
(``vid_dup_finder_lib/src/video_hashing/video_hash.rs:319-372``): triangle
inequality, symmetry, and zero self-distance over seeded random hashes, plus
packing roundtrip checks specific to the device bit layout.
"""

import numpy as np
import pytest

from vid_dup_finder_lib_tpu import HASH_BITS, VideoHash
from vid_dup_finder_lib_tpu.video_hash import (
    hashes_to_matrix,
    pack_bits,
    unpack_bits,
)


def test_triangle_inequality():
    rng = np.random.default_rng(1)
    for _ in range(1000):
        h1 = VideoHash.random_hash(rng)
        h2 = VideoHash.random_hash(rng)
        h3 = VideoHash.random_hash(rng)
        assert h1.hamming_distance(h2) <= h1.hamming_distance(
            h3
        ) + h2.hamming_distance(h3)


def test_distance_between_two_empty_hashes_is_0():
    assert VideoHash.empty_hash("").hamming_distance(VideoHash.empty_hash("")) == 0


def test_distance_between_two_full_hashes_is_0():
    assert VideoHash.full_hash("").hamming_distance(VideoHash.full_hash("")) == 0


def test_empty_vs_full_distance_is_1024():
    # full_hash sets all 1024 storage bits (reference full_hash uses
    # usize::MAX in all words), so raw distance includes the 24 pad bits.
    assert (
        VideoHash.empty_hash("").hamming_distance(VideoHash.full_hash("")) == 1024
    )


def test_symmetry():
    rng = np.random.default_rng(2)
    for _ in range(1000):
        h1 = VideoHash.random_hash(rng)
        h2 = VideoHash.random_hash(rng)
        assert h1.hamming_distance(h2) == h2.hamming_distance(h1)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=HASH_BITS, dtype=np.uint8).astype(bool)
    assert np.array_equal(unpack_bits(pack_bits(bits)), bits)


def test_bit_position_convention():
    # bit i -> u64 word i//64, position i%64, LSB-first (Lsb0).
    bits = np.zeros(HASH_BITS, dtype=bool)
    bits[0] = True
    bits[65] = True
    words = pack_bits(bits)
    assert words[0] == 1
    assert words[1] == 2
    # the same bitstream viewed as u32 words: bit 65 -> word32 2, pos 1
    h = VideoHash(words)
    w32 = h.packed_u32()
    assert w32[0] == 1 and w32[2] == 2
    assert VideoHash.from_packed_u32(w32) == VideoHash(words)


def test_from_packed_u32_noncontiguous_row():
    # Regression: rows of a transposed / strided matrix (e.g. a fetched
    # device library viewed column-major) used to crash the u4->u8 view
    # with "last axis must be contiguous".
    rng = np.random.default_rng(9)
    h = VideoHash.random_hash(rng)
    w32 = h.packed_u32()
    mat_t = np.ascontiguousarray(np.stack([w32, w32]).T)  # columns of this are strided
    assert VideoHash.from_packed_u32(mat_t[:, 0]) == VideoHash(h.hash)
    assert VideoHash.from_packed_u32(w32[::-1][::-1]) == VideoHash(h.hash)


def test_many_from_packed_u32_matches_per_row():
    rng = np.random.default_rng(10)
    m = rng.integers(0, 2**32, (64, 32), dtype=np.uint64).astype(
        np.uint32
    )
    paths = [f"/v/{i}.mp4" for i in range(64)]
    durs = rng.integers(1, 7200, 64)
    bulk = VideoHash.many_from_packed_u32(m, paths, durs)
    for i in (0, 1, 31, 63):
        assert bulk[i] == VideoHash.from_packed_u32(
            m[i], paths[i], int(durs[i])
        )
    # frozen semantics: rows are read-only views
    import pytest as _pytest

    with _pytest.raises(ValueError):
        bulk[0].hash[0] = 1
    # non-contiguous input matrices work too
    strided = np.ascontiguousarray(m.T).T
    bulk2 = VideoHash.many_from_packed_u32(strided, paths, durs)
    assert bulk2[5] == bulk[5]


def test_hash_with_spatial_distance_exact():
    rng = np.random.default_rng(4)
    base = VideoHash.random_hash(rng)
    for d in (1, 17, 100, 500):
        other = base.hash_with_spatial_distance(d, rng)
        assert base.hamming_distance(other) == d


def test_with_duration_and_src_path():
    h = VideoHash.empty_hash("a")
    assert h.with_duration(5).duration == 5
    assert h.with_src_path("b").src_path == "b"
    assert h.with_duration(5).with_src_path("b").hamming_distance(h) == 0


def test_json_roundtrip():
    rng = np.random.default_rng(5)
    h = VideoHash.random_hash(rng).with_src_path("/x/y.mp4").with_duration(33)
    assert VideoHash.from_json(h.to_json()) == h


def test_normalized_distance():
    rng = np.random.default_rng(6)
    base = VideoHash.random_hash(rng)
    other = base.hash_with_spatial_distance(350, rng)
    assert base.normalized_hamming_distance(other) == pytest.approx(0.35)


def test_hashes_to_matrix_shape():
    rng = np.random.default_rng(7)
    hs = [VideoHash.random_hash(rng) for _ in range(5)]
    m = hashes_to_matrix(hs)
    assert m.shape == (5, 32) and m.dtype == np.uint32
    assert hashes_to_matrix([]).shape == (0, 32)
