"""Multi-device scaling: device meshes, sharded hashing, ring search.

The reference is a single-process CPU tool (SURVEY.md section 2.7); its only
parallelism is a rayon pool over videos.  The device equivalents:

* **data parallelism** over the video batch axis for hash generation
  (``shard_map`` over a mesh axis; each device hashes its shard);
* **ring parallelism** over the library axis N for the all-pairs search:
  each device owns a row block of the bit-packed hash matrix and column
  blocks rotate around the ring via ``ppermute`` — structurally the
  ring-attention pattern, applied to Hamming adjacency.
"""

from .mesh import make_mesh
from .sharded_search import (
    banded_adjacency_ring,
    ring_candidate_scan,
    sharded_hash_batch,
)

__all__ = [
    "banded_adjacency_ring",
    "make_mesh",
    "ring_candidate_scan",
    "sharded_hash_batch",
]
