"""Video duplicate finder on JAX.

A JAX/XLA/Pallas framework with the capabilities of the
reference ``vid_dup_finder_lib`` Rust crate: perceptual video hashing
(16-frame grayscale 3D-DCT sign hash) and tolerance-based duplicate search.

Public surface mirrors the reference's re-exports
(``vid_dup_finder_lib/src/lib.rs:132-145``): ``VideoHash``,
``VideoHashBuilder``/``CreationOptions``, ``search``,
``search_with_references``, ``MatchGroup``, ``Cropdetect``, the default
tunables, and the error type.
"""

from .definitions import (
    Cropdetect,
    DCT_SIZE,
    DEFAULT_SEARCH_TOLERANCE,
    DEFAULT_VID_HASH_DURATION,
    DEFAULT_VID_HASH_SKIP_FORWARD,
    HASH_BITS,
    HASH_SIZE,
    TOLERANCE_SCALING_FACTOR,
)
from .errors import NotEnoughFrames, NotVideo, VdfError, VidProc
from .crop import Crop
from .match_group import MatchGroup, TooFewEntries
from .search import Search, search, search_with_references
from .video_hash import VideoHash, VideoHashBatch

__all__ = [
    "Crop",
    "Cropdetect",
    "CreationOptions",
    "DCT_SIZE",
    "DEFAULT_SEARCH_TOLERANCE",
    "DEFAULT_VID_HASH_DURATION",
    "DEFAULT_VID_HASH_SKIP_FORWARD",
    "HASH_BITS",
    "HASH_SIZE",
    "MatchGroup",
    "NotEnoughFrames",
    "NotVideo",
    "Search",
    "TOLERANCE_SCALING_FACTOR",
    "TooFewEntries",
    "VdfError",
    "VideoHash",
    "VideoHashBatch",
    "VideoHashBuilder",
    "VidProc",
    "search",
    "search_with_references",
]

__version__ = "0.4.0"  # kept in sync with pyproject.toml


def __getattr__(name):
    # Builder pulls in the ingest stack; import lazily so pure hash/search
    # users never touch it.
    if name in ("VideoHashBuilder", "CreationOptions"):
        from .models import builder as _b

        return getattr(_b, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
