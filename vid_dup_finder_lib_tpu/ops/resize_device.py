"""Device-side batched crop+resize — BIT-EXACT twin of the host path.

The Lanczos3 crop+resize is two weight-matrix products per frame
(``ops/golden.resize_weights``), so for a batch of same-resolution videos
the whole preprocessing stage becomes two batched matmuls.  Since
round 3 the device runs the SAME u8 fixed-point arithmetic as the host
golden path (``golden.crop_resize_golden``, fast_image_resize's default
U8 pipeline, ``resize_gray.rs:34-47``): horizontal pass first, i16
coefficients at the Normalizer16 precision, a 2^(p-1) rounding seed,
arithmetic shift, and a u8 clamp after EACH pass.

Exactness in f32: coefficients are integers |k| <= 2^15 and pixels u8,
so every product (<= 2^23) and every partial sum (<= 255 * sum|k| <
2^24) is exactly representable in f32 — HIGHEST-precision f32 matmuls
therefore compute the exact integer accumulator, and the
floor((ss + 2^(p-1)) / 2^p) epilogue reproduces the host's arithmetic
shift bit-for-bit.  Device cubes equal host cubes EXACTLY (pinned by
tests/test_parallel.py's device-preproc tests).

This is the "crop+resize as matmul by precomputed per-resolution weight
matrices" design from SURVEY.md section 7.2 step 4.  The host groups
videos into (resolution, crop) buckets and precomputes the weight pair
per bucket.

Trade-off: shipping full-resolution frames costs 16*H*W bytes/video of
h2d instead of 4 KB per cube; the pipeline keeps host resize as its
default and this path is opt-in (not measured on this card).
"""

from __future__ import annotations

import functools

import numpy as np

from ..crop import Crop
from ..definitions import DCT_SIZE
from .golden import _fir_i16_weights, resize_weights


@functools.lru_cache(maxsize=256)
def _weights_for(
    height: int, width: int, crop_args: tuple[int, int, int, int] | None
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """(K_v [16, H], K_h [16, W] integer-valued f32, p_v, p_h) for one
    (resolution, crop) bucket — i16 fixed-point coefficients identical
    to the host golden path's."""
    if crop_args is None:
        x, y, cw, ch = 0, 0, width, height
    else:
        x, y, cw, ch = crop_args
    wv = resize_weights(
        height, DCT_SIZE, crop_start=float(y), crop_size=float(ch)
    )
    wh = resize_weights(
        width, DCT_SIZE, crop_start=float(x), crop_size=float(cw)
    )
    kv, pv = _fir_i16_weights(wv)
    kh, ph = _fir_i16_weights(wh)
    return kv.astype(np.float32), kh.astype(np.float32), pv, ph


@functools.cache
def _build_resize(pv: int, ph: int):
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    seed_h = float(1 << (ph - 1)) if ph else 0.0
    seed_v = float(1 << (pv - 1)) if pv else 0.0
    inv_h = 1.0 / float(1 << ph)
    inv_v = 1.0 / float(1 << pv)

    @jax.jit
    def resize_batch(frames, kv, kh):
        """uint8[B, 16, H, W] -> uint8[B, 16, 16, 16], two fixed-point
        passes (horizontal then vertical), u8 rounding between passes."""
        x = frames.astype(jnp.float32)
        # horizontal pass: convolve the width axis, round to u8
        x = jnp.einsum("bthw,pw->bthp", x, kh, precision=hi)
        x = jnp.clip(jnp.floor((x + seed_h) * inv_h), 0.0, 255.0)
        # vertical pass
        x = jnp.einsum("oh,bthp->btop", kv, x, precision=hi)
        x = jnp.clip(jnp.floor((x + seed_v) * inv_v), 0.0, 255.0)
        return x.astype(jnp.uint8)

    return resize_batch


def resize_frames_device(
    frames: np.ndarray, crop: Crop | None = None
) -> np.ndarray:
    """Batched device crop+resize: uint8[B, 16, H, W] -> uint8[B, 16, 16, 16].

    All frames in the batch share one resolution and crop (one bucket).
    Output is bit-identical to ``golden.crop_resize_golden`` per frame.
    """
    import jax.numpy as jnp

    b, t, h, w = frames.shape
    assert t == DCT_SIZE
    crop_args = None if crop is None else crop.as_view_args()
    kv, kh, pv, ph = _weights_for(h, w, crop_args)
    fn = _build_resize(pv, ph)
    out = fn(jnp.asarray(frames), jnp.asarray(kv), jnp.asarray(kh))
    return np.asarray(out)
