"""Batched streaming hash pipeline.

The reference hashes one video per rayon task
(``video_hash_filesystem_cache.rs:244-249``); this pipeline inverts that
into batched dataflow (SURVEY.md section 7.1): a host thread pool
decodes+crops+resizes videos into fixed-shape 16x16x16 cubes, batches of
cubes stream to the device (h2d transfer and hash of batch k overlap with
the decode of batch k+1 — JAX dispatch is asynchronous), and packed hashes
come back 128 bytes per video.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable

import numpy as np

from ..errors import VdfError, VidProc
from ..video_hash import VideoHash
from .builder import CreationOptions, prepare_frames

DEFAULT_BATCH = 256


def safe_prepare(path: str, options: CreationOptions):
    """Decode + preprocess one video, mapping failures to CACHEABLE error
    values (generic_cache_if.rs:22-44's contract): VdfError passes
    through, anything a decode library throws becomes VidProc.  Returns
    (path, cube | None, duration, error | None) — the one shared helper
    for the pipeline and the cache updater, so the error-wrapping rules
    cannot drift between paths.
    """
    try:
        cube, dur = prepare_frames(path, options)
        return (path, cube, dur, None)
    except VdfError as e:
        return (path, None, 0, e)
    except Exception as e:  # decode libs can throw anything
        return (path, None, 0, VidProc(f"{e!r}"))


def hash_raw_frames_device(
    frames: np.ndarray,
    letterbox: bool = True,
    crops: list | None = None,
) -> np.ndarray:
    """Fully on-device preprocessing + hash for a same-resolution batch.

    uint8[B, 16, H, W] raw decoded frames -> packed uint32[B, 32]:
    device letterbox detection (union over sampled frames) -> device
    Lanczos3 crop+resize (per-crop weight buckets) -> batched DCT hash
    kernel.  This is BASELINE.json config 5 ("cropdetect preproc fused"):
    after decode, no pixel touches the host.

    Pass ``crops`` (one per video) to skip detection — the production
    path for Cropdetect.MOTION/NONE, whose detection runs on host
    (motion morphology is scipy by design) while resize+hash stay on
    device.

    Crops are data-dependent, so videos are grouped by detected crop and
    each group resizes with its own precomputed weight pair.
    """
    from ..ops.hash_kernel import hash_cubes_device
    from ..ops.letterbox_device import cropdetect_letterbox_device
    from ..ops.resize_device import resize_frames_device

    b = frames.shape[0]
    if crops is not None:
        assert len(crops) == b
    elif letterbox:
        crops = cropdetect_letterbox_device(frames)
    else:
        h, w = frames.shape[2:]
        from ..crop import Crop

        crops = [Crop.from_edge_offsets((w, h), 0, 0, 0, 0)] * b

    cubes = np.empty((b, 16, 16, 16), dtype=np.uint8)
    by_crop: dict = {}
    for i, c in enumerate(crops):
        by_crop.setdefault(c, []).append(i)
    for crop, idxs in by_crop.items():
        cubes[idxs] = resize_frames_device(frames[idxs], crop)
    return hash_cubes_device(cubes)


def hash_videos(
    paths: Iterable[str],
    options: CreationOptions = CreationOptions(),
    batch_size: int = DEFAULT_BATCH,
    decode_workers: int = 8,
    progress: Callable[[int, int], None] | None = None,
    device_preproc: bool | None = None,
) -> dict[str, VideoHash | VdfError]:
    """Hash many videos; returns {path: VideoHash | VdfError}.

    Decode errors become values (the cache stores them), not exceptions.

    ``device_preproc`` (default: VDF_DEVICE_PREPROC env) moves the
    letterbox detection and Lanczos3 resize onto the device too — the
    host only decodes; same-resolution batches ride
    ``hash_raw_frames_device``.  Group-parity with the host path is
    pinned by tests (<= 2 near-zero DCT sign flips per hash).
    """
    if device_preproc is None:
        device_preproc = os.environ.get("VDF_DEVICE_PREPROC", "") not in (
            "",
            "0",
        )
    if device_preproc:
        return _hash_videos_device_preproc(
            paths, options, batch_size, decode_workers, progress
        )
    paths = [os.fspath(p) for p in paths]
    results: dict[str, VideoHash | VdfError] = {}

    def prepare(p: str):
        return safe_prepare(p, options)

    def dispatch(batch):
        metas = [(p, dur) for (p, _, dur, _) in batch]
        cubes = np.stack([c for (_, c, _, _) in batch])
        from ..ops.hash_kernel import hash_cubes_device_async

        return metas, hash_cubes_device_async(cubes)

    pending: list[tuple[list, object]] = []
    buf: list = []
    done = 0
    total = len(paths)
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        # pool.map streams results in order while prefetching ahead, so
        # decode of batch k+1 overlaps the device hash of batch k
        for item in pool.map(prepare, paths):
            p, cube, dur, err = item
            done += 1
            if err is not None:
                results[p] = err
            else:
                buf.append(item)
                if len(buf) >= batch_size:
                    pending.append(dispatch(buf))
                    buf = []
            if progress:
                progress(done, total)
        if buf:
            pending.append(dispatch(buf))

    for metas, packed in pending:
        rows = np.asarray(packed)
        for (p, dur), row in zip(metas, rows):
            results[p] = VideoHash.from_packed_u32(
                np.ascontiguousarray(row), p, dur
            )
    return results


def _hash_videos_device_preproc(
    paths: Iterable[str],
    options: CreationOptions,
    batch_size: int,
    decode_workers: int,
    progress: Callable[[int, int], None] | None,
) -> dict[str, VideoHash | VdfError]:
    """Device-preproc variant: host decodes raw frames only; letterbox
    detection, Lanczos3 crop+resize and the DCT hash all run on device
    over same-resolution batches (SURVEY.md section 7.2 step 4)."""
    from ..definitions import Cropdetect
    from .builder import prepare_raw_frames

    paths = [os.fspath(p) for p in paths]
    results: dict[str, VideoHash | VdfError] = {}
    host_crops = options.cropdetect is not Cropdetect.LETTERBOX

    def prepare(p: str):
        try:
            frames, crop, dur = prepare_raw_frames(p, options)
            return (p, frames, crop, dur, None)
        except VdfError as e:
            return (p, None, None, 0, e)
        except Exception as e:
            return (p, None, None, 0, VidProc(f"{e!r}"))

    def flush(batch) -> None:
        frames = np.stack([f for (_, f, _, _, _) in batch])
        crops = [c for (_, _, c, _, _) in batch] if host_crops else None
        packed = hash_raw_frames_device(frames, crops=crops)
        for (p, _, _, dur, _), row in zip(batch, packed):
            results[p] = VideoHash.from_packed_u32(
                np.ascontiguousarray(row), p, dur
            )

    # RAW frames are big (a 1080p stack is ~33 MB vs ~4 KB for a cube):
    # bound each resolution group by BYTES as well as count, or a
    # high-resolution library buffers multiple GB on this host
    max_group_bytes = int(
        os.environ.get("VDF_PREPROC_BATCH_BYTES", str(512 * 2**20))
    )
    groups: dict[tuple[int, int], list] = {}
    done = 0
    total = len(paths)
    with ThreadPoolExecutor(max_workers=decode_workers) as pool:
        for item in pool.map(prepare, paths):
            p, frames, crop, dur, err = item
            done += 1
            if err is not None:
                results[p] = err
            else:
                res = frames.shape[1:]
                groups.setdefault(res, []).append(item)
                group_bytes = len(groups[res]) * frames.nbytes
                if (
                    len(groups[res]) >= batch_size
                    or group_bytes >= max_group_bytes
                ):
                    flush(groups.pop(res))
            if progress:
                progress(done, total)
    for batch in groups.values():
        flush(batch)
    return results
