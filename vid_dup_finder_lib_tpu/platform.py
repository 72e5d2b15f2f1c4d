"""The one place that decides which implementation runs on this device.

``jax.default_backend()`` maps to:

* ``"gpu"``: the compiled device kernels (the two-phase banded sweep
  states, the sharded ring and refs searches);
* ``"cpu"``: the host paths, with Pallas kernels in interpret mode for
  the kernel tests;
* anything else: an error.

Device memory budgets come from the device itself
(``memory_stats()["bytes_limit"]``); the CPU backend reports none, so it
plans against ``CPU_TEST_BYTES_LIMIT``, a test default.
"""

from __future__ import annotations

import os

# Planning budget on the CPU backend, which reports no memory limit.  A
# test default only: sized so the CPU tests see budgets of the same
# order as a small accelerator, never a measurement of any device.
CPU_TEST_BYTES_LIMIT = 16 * 2**30

# Bytes per library row: the packed hash and its int8 +/-1 expansion.
PACKED_ROW_BYTES = 128
PM1_ROW_BYTES = 1024


def backend() -> str:
    """``"gpu"`` or ``"cpu"``; any other JAX backend is an error."""
    import jax

    b = jax.default_backend()
    if b not in ("gpu", "cpu"):
        raise RuntimeError(
            f"unsupported JAX backend {b!r}: this package runs on 'gpu'"
            f" (CUDA) or 'cpu'"
        )
    return b


def device_sweep() -> bool:
    """Route searches through the device sweep states (GPU only; the CPU
    backend takes the native host sweep)."""
    return backend() == "gpu"


def interpret() -> bool:
    """Pallas interpret mode: chosen on the CPU backend only."""
    return backend() == "cpu"


def check_interpret(interpret_mode: bool) -> None:
    """Raise if a kernel is about to run interpreted on a GPU."""
    if interpret_mode and backend() == "gpu":
        raise RuntimeError(
            "a Pallas kernel reached interpret mode on a GPU; compiled"
            " kernels are required there"
        )


def bytes_limit() -> int:
    """Device memory this process may allocate: the first device's
    ``memory_stats()["bytes_limit"]`` on a GPU, ``CPU_TEST_BYTES_LIMIT``
    on the CPU backend."""
    import jax

    if backend() == "cpu":
        return CPU_TEST_BYTES_LIMIT
    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise RuntimeError("the GPU reports no memory_stats()['bytes_limit']")
    return int(stats["bytes_limit"])


def budget_bytes(env: str, fraction: float) -> float:
    """A planning budget: ``env`` (GB, 2^30) when set, else ``fraction``
    of ``bytes_limit()``."""
    v = os.environ.get(env)
    if v is not None:
        return float(v) * 2**30
    return fraction * bytes_limit()


def resident_rows() -> int:
    """Library size above which the fully resident int8 +/-1 matrix
    (plus the packed rows) would take more than a quarter of the device
    budget; larger libraries slide a +/-1 window instead.
    ``VDF_WINDOWED_THRESHOLD`` overrides."""
    v = os.environ.get("VDF_WINDOWED_THRESHOLD")
    if v is not None:
        return int(v)
    return int(bytes_limit() / 4 // (PM1_ROW_BYTES + PACKED_ROW_BYTES))
