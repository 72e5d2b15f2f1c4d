"""Device (JAX/XLA) hash kernel: batched 3D-DCT sign hashing.

Batched replacement for the reference's per-video ``Dct3d`` path
(``dct_3d.rs`` + ``raw_dct_ops.rs:107-142``): instead of rustdct rows +
materialized transposes per video, a whole batch of 16x16x16 frame cubes is
hashed in one XLA program — three separable batched 16x16 DCT matmuls (one
per cube axis), sign, and a bitpack, all fused by XLA.

Precision: the reference computes in f64; the matmuls here are f32 at
``Precision.HIGHEST`` (true f32, not TF32 or one-pass bf16, under which
sign bits of near-zero DCT coefficients would flip).  Signs can differ from
the golden f64 model only where a coefficient is within f32 rounding of
zero — empirically <0.05% of bits on random inputs, absorbed by the
search tolerance (BASELINE.md defines parity at the dup-group level).
"""

from __future__ import annotations

import numpy as np

from ..definitions import DCT_SIZE, HASH_BITS, HASH_BITS_PADDED, HASH_SIZE
from .golden import dct2_matrix


def _build():
    from ..utils.jaxconfig import enable_compilation_cache

    enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    dct = jnp.asarray(dct2_matrix(DCT_SIZE, np.float32))

    def hash_cubes(frames: jax.Array) -> jax.Array:
        """uint8[B, 16, 16, 16] frame stacks (t, row, col) -> uint32[B, 32].

        Matches the golden model: cube[t, x, y] = frame[t, y, x] - 128
        (the reference transposes each frame into the cube, dct_3d.rs:40-44),
        DCT-II along each axis, sign of the 10x10x10 corner, Lsb0 bitpack.
        """
        hi = jax.lax.Precision.HIGHEST  # true f32, not TF32 or bf16
        x = frames.astype(jnp.float32).transpose(0, 1, 3, 2) - 128.0
        # DCT along each cube axis: y, x, t (order irrelevant).
        x = jnp.einsum("ky,btxy->btxk", dct, x, precision=hi)
        x = jnp.einsum("jx,btxk->btjk", dct, x, precision=hi)
        x = jnp.einsum("it,btjk->bijk", dct, x, precision=hi)
        corner = x[:, :HASH_SIZE, :HASH_SIZE, :HASH_SIZE]
        bits = (corner > 0.0).reshape(frames.shape[0], HASH_BITS)
        padded = jnp.pad(bits, ((0, 0), (0, HASH_BITS_PADDED - HASH_BITS)))
        weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
        return jnp.sum(
            padded.reshape(frames.shape[0], HASH_BITS_PADDED // 32, 32).astype(
                jnp.uint32
            )
            * weights,
            axis=-1,
            dtype=jnp.uint32,
        )

    return jax.jit(hash_cubes)


_HASH_CUBES = None


def _batch_bucket(b: int) -> int:
    """Fixed compiled batch shapes: powers of two up to 256, then
    multiples of 256.  jax.jit specializes per exact batch size, so a
    6-video cache update must not compile a one-off uint8[6,...]
    executable."""
    if b <= 256:
        n = 8
        while n < b:
            n *= 2
        return n
    return -(-b // 256) * 256


def hash_cubes_device_async(frames16: np.ndarray):
    """Dispatch a batch hash without blocking; returns the device array
    (bucket-padded: rows past the input batch are pad garbage — callers
    zip against their own metadata or slice).

    JAX dispatch is asynchronous, so the caller can keep decoding the next
    batch while this one computes (the double-buffered streaming pattern).
    """
    global _HASH_CUBES
    if _HASH_CUBES is None:
        _HASH_CUBES = _build()
    frames16 = np.ascontiguousarray(frames16, dtype=np.uint8)
    assert frames16.ndim == 4 and frames16.shape[1:] == (
        DCT_SIZE,
        DCT_SIZE,
        DCT_SIZE,
    ), frames16.shape
    b = frames16.shape[0]
    bucket = _batch_bucket(b)
    if bucket != b:
        frames16 = np.concatenate(
            [
                frames16,
                np.zeros((bucket - b,) + frames16.shape[1:], np.uint8),
            ]
        )
    return _HASH_CUBES(frames16)


def hash_cubes_device(frames16: np.ndarray) -> np.ndarray:
    """Hash a batch of uint8[B, 16, 16, 16] cubes on the default device.

    Returns packed uint32[B, 32] as a NumPy array.
    """
    b = frames16.shape[0]
    return np.asarray(hash_cubes_device_async(frames16))[:b]
