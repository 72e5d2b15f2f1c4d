"""The ``VideoHash`` value type.

Behavioral port of the reference's hash value
(``vid_dup_finder_lib/src/video_hashing/video_hash.rs:27-229``): 1000 bits of
sign-quantized 3D-DCT coefficients packed LSB-first, plus the source path and
the duration in whole seconds.

Packing convention (identical to the reference's
``BitArray<[usize; 16], Lsb0>``): hash bit ``i`` lives in 64-bit word
``i // 64`` at bit position ``i % 64``.  The device-side format is the same
bitstream viewed as 32 little-endian ``uint32`` words, so conversion is a
pure ``view`` with no bit shuffling.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator

import numpy as np

from .definitions import (
    HASH_BITS,
    HASH_SIZE,
    HASH_WORDS,
    HASH_WORDS32,
    TOLERANCE_SCALING_FACTOR,
)


class VideoHashBatch(list):
    """A bulk-constructed ``list[VideoHash]`` carrying its backing arrays.

    Produced by :meth:`VideoHash.many_from_packed_u32`.  Behaves exactly
    like a plain list of hashes; additionally exposes the vectorized
    columns the objects were built from so ``Search`` construction can
    skip every per-object Python loop (durations ``np.fromiter``, path
    ``os.fspath`` encode, ``hashes_to_matrix``) — at 16M entries those
    loops cost ~10 s PER ``Search`` on the host, the dominant
    steady-state overhead of the public refs search.

    * ``packed_u32`` — ``uint32[n, 32]``, the device search format (the
      rows' ``hash`` fields are read-only views into this buffer).
    * ``durations`` — ``int64[n]``.
    * ``paths_bytes`` — bytewise path array (``np.bytes_``) for the
      (duration, path) sort, or ``None`` when a path refuses ASCII
      encoding (``Search`` then falls back to the exact per-object key).

    Any in-place list mutation (append/sort/item assignment/...) marks
    the arrays stale; consumers must check :attr:`arrays_valid` and fall
    back to per-object iteration.  Slicing returns a plain list.
    """

    __slots__ = ("packed_u32", "durations", "paths_bytes", "arrays_valid")

    def __init__(self, entries, packed_u32, durations, paths_bytes):
        super().__init__(entries)
        self.packed_u32 = packed_u32
        self.durations = durations
        self.paths_bytes = paths_bytes
        self.arrays_valid = True


def _batch_invalidating(name: str):
    base = getattr(list, name)

    def method(self, *args, **kwargs):
        self.arrays_valid = False
        return base(self, *args, **kwargs)

    method.__name__ = name
    return method


for _name in (
    "append", "extend", "insert", "remove", "pop", "clear", "sort",
    "reverse", "__setitem__", "__delitem__", "__iadd__", "__imul__",
):
    setattr(VideoHashBatch, _name, _batch_invalidating(_name))
del _name


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean vector of length >= HASH_BITS (extra ignored) into
    uint64[HASH_WORDS], LSB-first within each word."""
    bits = np.asarray(bits, dtype=np.uint8)[:HASH_BITS]
    padded = np.zeros(HASH_WORDS * 64, dtype=np.uint8)
    padded[: bits.size] = bits
    # np.packbits packs MSB-first per byte; request little bit order for Lsb0.
    as_bytes = np.packbits(padded, bitorder="little")
    return as_bytes.view("<u8").copy()


def unpack_bits(words: np.ndarray) -> np.ndarray:
    """Inverse of pack_bits: uint64[HASH_WORDS] -> bool[HASH_BITS]."""
    as_bytes = np.asarray(words, dtype="<u8").tobytes()
    bits = np.unpackbits(np.frombuffer(as_bytes, dtype=np.uint8), bitorder="little")
    return bits[:HASH_BITS].astype(bool)


@dataclass(frozen=True)
class VideoHash:
    """A perceptual hash of one video file."""

    hash: np.ndarray = field(
        default_factory=lambda: np.zeros(HASH_WORDS, dtype=np.uint64)
    )  # uint64[16], Lsb0 packing
    src_path: str = ""
    duration: int = 0  # whole seconds (u32 truncation in the reference)

    def __post_init__(self) -> None:
        h = np.asarray(self.hash, dtype=np.uint64)
        assert h.shape == (HASH_WORDS,)
        h.setflags(write=False)
        object.__setattr__(self, "hash", h)

    # -- equality / ordering / hashing --------------------------------------

    def _key(self):
        return (self.hash.tobytes(), self.src_path, self.duration)

    def __eq__(self, other) -> bool:
        if not isinstance(other, VideoHash):
            return NotImplemented
        return self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    # -- metric --------------------------------------------------------------

    def hamming_distance(self, other: "VideoHash") -> int:
        """Per-word XOR + popcount (video_hash.rs:190-192,311-317)."""
        return int(np.bitwise_count(self.hash ^ other.hash).sum())

    def normalized_hamming_distance(self, other: "VideoHash") -> float:
        """Raw distance scaled into [0, 1] (video_hash.rs:200-204)."""
        return self.hamming_distance(other) / TOLERANCE_SCALING_FACTOR

    # -- accessors -------------------------------------------------------------

    def raw_hash(self) -> Iterator[bool]:
        """Iterate the 1000 raw hash bits (video_hash.rs:206-218)."""
        return iter(unpack_bits(self.hash).tolist())

    def hash_bits(self) -> np.ndarray:
        """The 1000 hash bits as a bool vector (video_hash.rs:226-229)."""
        return unpack_bits(self.hash)

    @staticmethod
    def hash_frame_dimensions() -> tuple[int, int]:
        return (HASH_SIZE, HASH_SIZE)

    # -- conversions -------------------------------------------------------------

    def packed_u32(self) -> np.ndarray:
        """Device packing: the same bitstream as uint32[32] little-endian."""
        return self.hash.view("<u4").copy()

    @staticmethod
    def from_packed_u32(
        words32: np.ndarray, src_path: str = "", duration: int = 0
    ) -> "VideoHash":
        w = np.ascontiguousarray(words32, dtype="<u4")
        assert w.shape == (HASH_WORDS32,)
        return VideoHash(w.view("<u8").copy(), src_path, duration)

    @staticmethod
    def many_from_packed_u32(
        matrix: np.ndarray,
        src_paths: Iterable[str],
        durations: Iterable[int],
    ) -> "VideoHashBatch":
        """Bulk ``from_packed_u32`` over a ``uint32[k, 32]`` matrix: ONE
        u4->u8 reinterpret of the whole matrix, each hash holding a
        read-only row view (no per-row copy).  At 16M rows the per-row
        constructor spends ~410 s; this path is ~3x faster — the library
        build half of large ``search(device_library=)`` workloads.

        Returns a :class:`VideoHashBatch` (a ``list`` subclass) whose
        backing arrays let ``Search`` skip all per-object iteration."""
        w32 = np.ascontiguousarray(matrix, dtype="<u4")
        w = w32.view("<u8")
        assert w.shape[1] == HASH_WORDS
        w.setflags(write=False)
        src_paths = list(src_paths)
        durations = list(durations)
        if not (len(src_paths) == len(durations) == w.shape[0]):
            # a silent zip-truncation here would drop hashes (and their
            # duplicates) without a trace; a too-long paths list would
            # die as an opaque IndexError mid-loop
            raise ValueError(
                f"many_from_packed_u32: matrix has {w.shape[0]} rows"
                f" but got {len(src_paths)} src_paths and"
                f" {len(durations)} durations — all three must match"
            )
        # the frozen-dataclass __init__ + __post_init__ dominate at this
        # volume; validation already happened once on the whole matrix,
        # so construct directly (rows are read-only u64 views)
        new, setattr_ = VideoHash.__new__, object.__setattr__
        out: list[VideoHash] = []
        path_keys: list[str] = []
        dur_list: list[int] = []
        for i, (p, d) in enumerate(zip(src_paths, durations)):
            o = new(VideoHash)
            setattr_(o, "hash", w[i])
            setattr_(o, "src_path", p)
            d = int(d)
            setattr_(o, "duration", d)
            out.append(o)
            path_keys.append(p if type(p) is str else os.fspath(p))
            dur_list.append(d)
        k = len(out)
        try:
            # np.bytes_ conversion ASCII-encodes; non-ASCII paths (where
            # UTF-8 byte order and code-point order can diverge) raise
            # and drop to the exact per-object sort key in Search
            paths_arr = np.array(path_keys, dtype=np.bytes_) if k else None
        except (UnicodeEncodeError, TypeError, ValueError):
            paths_arr = None
        return VideoHashBatch(
            out,
            w32[:k],
            np.array(dur_list, dtype=np.int64),
            paths_arr,
        )

    @staticmethod
    def from_bits(
        bits: np.ndarray | Iterable[bool], src_path: str = "", duration: int = 0
    ) -> "VideoHash":
        return VideoHash(pack_bits(np.fromiter(bits, dtype=np.uint8, count=-1)
                                   if not isinstance(bits, np.ndarray) else bits),
                         src_path, duration)

    # -- serde (cache format) ----------------------------------------------------

    def to_json(self) -> dict:
        return {
            "hash": [int(w) for w in self.hash],
            "src_path": self.src_path,
            "duration": int(self.duration),
        }

    @staticmethod
    def from_json(obj: dict) -> "VideoHash":
        return VideoHash(
            np.array(obj["hash"], dtype=np.uint64), obj["src_path"], int(obj["duration"])
        )

    # -- test utilities (video_hash.rs test_util, :240-308) ------------------------

    def with_duration(self, duration: int) -> "VideoHash":
        return replace(self, duration=duration)

    def with_src_path(self, src_path: str) -> "VideoHash":
        return replace(self, src_path=src_path)

    @staticmethod
    def empty_hash(name: str = "") -> "VideoHash":
        return VideoHash(np.zeros(HASH_WORDS, dtype=np.uint64), name, 0)

    @staticmethod
    def full_hash(name: str = "") -> "VideoHash":
        return VideoHash(np.full(HASH_WORDS, np.uint64(0xFFFFFFFFFFFFFFFF)), name, 0)

    @staticmethod
    def random_hash(rng: np.random.Generator) -> "VideoHash":
        """1000 fair-coin bits; the 24 trailing storage bits stay zero."""
        bits = rng.integers(0, 2, size=HASH_BITS, dtype=np.uint8)
        return VideoHash(pack_bits(bits), "", 0)

    def hash_with_spatial_distance(
        self, target_distance: int, rng: np.random.Generator
    ) -> "VideoHash":
        """A hash at exactly ``target_distance`` from this one.

        The reference (video_hash.rs:263-287) random-walks single-bit flips
        over the full 1024-bit storage until the distance is hit; we flip
        ``target_distance`` distinct random storage bits directly — the same
        contract (exact distance, any storage bit may differ) without the
        walk's exponential slowdown above distance 512.
        """
        words = self.hash.copy()
        positions = rng.choice(HASH_WORDS * 64, size=target_distance, replace=False)
        for p in positions:
            words[p // 64] ^= np.uint64(1) << np.uint64(p % 64)
        assert int(np.bitwise_count(words ^ self.hash).sum()) == target_distance
        return VideoHash(words, self.src_path, self.duration)


def hashes_to_matrix(hashes: list[VideoHash]) -> np.ndarray:
    """Stack hashes into the device search format uint32[N, 32].

    One bytes-join instead of an np.stack of N per-hash arrays: ~6x
    faster at library scale (0.15 s vs 0.87 s at 200k) — this is on the
    object-API search path ahead of every sweep.  Byte-order safe: the
    stored hash dtype is explicitly little-endian ('<u8').
    """
    if not hashes:
        return np.zeros((0, HASH_WORDS32), dtype=np.uint32)
    buf = b"".join(
        np.asarray(h.hash, dtype="<u8").tobytes() for h in hashes
    )
    return (
        np.frombuffer(buf, dtype="<u4")
        .reshape(len(hashes), HASH_WORDS32)
        .copy()
    )
