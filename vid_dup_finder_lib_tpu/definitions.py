"""Tunable constants of the video-hash pipeline.

Values mirror the reference library's tunables
(``vid_dup_finder_lib/src/definitions.rs:5-54``) exactly; this build keeps
them bit-identical so hash/search semantics are comparable.
"""

from __future__ import annotations

import enum

# Default tolerance for searches: 0.0 = only identical hashes pair up,
# 1.0 = everything pairs with everything.  (definitions.rs:5)
DEFAULT_SEARCH_TOLERANCE: float = 0.35

# Seconds skipped before frame extraction, to get past title cards.
# (definitions.rs:18)
DEFAULT_VID_HASH_SKIP_FORWARD: float = 15.0

# Seconds of video content the hash is nominally built from. (definitions.rs:29)
DEFAULT_VID_HASH_DURATION: float = 10.0

# Edge length of the 3D DCT cube: DCT_SIZE frames of DCT_SIZE x DCT_SIZE
# grayscale pixels. (definitions.rs:34)
DCT_SIZE: int = 16

# Edge length of the low-frequency corner kept as the hash. (definitions.rs:36)
HASH_SIZE: int = 10

# User tolerance in [0, 1] is scaled by this into the integer Hamming domain.
# (definitions.rs:40)
TOLERANCE_SCALING_FACTOR: float = float(HASH_SIZE**3)

# Number of bits in a hash, and its packed storage sizes. (definitions.rs:42-43)
HASH_BITS: int = HASH_SIZE**3  # 1000
HASH_WORDS: int = -(-HASH_BITS // 64)  # 16 x u64 (reference packing)
HASH_WORDS32: int = -(-HASH_BITS // 32)  # 32 x u32 (device packing)

# Device-side padded bit width (32 packed uint32 words).
HASH_BITS_PADDED: int = 1024

# Duration windows used by the search engine. (search_algorithm.rs:99,174-185)
SELF_SEARCH_DURATION_FACTOR: float = 1.1  # forward window in search_self
REF_SEARCH_DURATION_LO: float = 0.95  # symmetric window in search_with_references
REF_SEARCH_DURATION_HI: float = 1.05


class Cropdetect(enum.Enum):
    """Letterbox-detection algorithms (definitions.rs:47-54)."""

    NONE = "None"
    LETTERBOX = "Letterbox"
    MOTION = "Motion"

    @classmethod
    def from_str(cls, s: str) -> "Cropdetect":
        for member in cls:
            if member.value.lower() == s.lower():
                return member
        raise ValueError(f"unknown Cropdetect: {s!r}")

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value
