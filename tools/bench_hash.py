"""Hash-generation throughput: cubes/sec through the XLA hash kernel.

Measures the device-side hash rate (decoded 16x16x16 cubes -> packed
hashes), i.e. the "Hashes/sec/chip" figure from BASELINE.json, excluding
host video decode (which is fundamentally bounded by codec work per video;
see BASELINE.md).  Also reports the end-to-end fixture-video rate.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vid_dup_finder_lib_tpu.utils.jaxconfig import (  # noqa: E402
    enable_compilation_cache,
)


def main() -> None:
    enable_compilation_cache()
    b = int(os.environ.get("VDF_HASH_BENCH_B", "8192"))
    rng = np.random.default_rng(0)
    cubes = rng.integers(0, 256, (b, 16, 16, 16), dtype=np.uint8)

    import jax.numpy as jnp

    from vid_dup_finder_lib_tpu.ops.hash_kernel import _build as _build_xla

    xla_fn = _build_xla()
    kernel = "xla"

    def run_device(x_dev):
        return xla_fn(x_dev)

    # device-resident compute rate; the upload is reported separately
    t = time.time()
    x_dev = jnp.asarray(cubes)
    x_dev.block_until_ready()
    upload_secs = time.time() - t

    run_device(x_dev)  # warm
    reps = 8
    t = time.time()
    for _ in range(reps):
        out = run_device(x_dev)
    out.block_until_ready()
    dt = (time.time() - t) / reps
    rate = b / dt

    print(
        json.dumps(
            {
                "metric": "hashes_per_sec_per_chip",
                "value": round(rate, 1),
                "unit": "hashes/s",
                "kernel": kernel,
                "batch": b,
                "secs_per_batch": round(dt, 4),
                "upload_secs": round(upload_secs, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
