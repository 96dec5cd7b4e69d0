"""Host data pipeline: shuffled camera batches decoded by a thread pool
(counterpart of data/dataset.py).

Replaces the reference's torch DataLoader over ``CameraDataset``
(scene/dataset.py, train.py:116-117).  Batches are numpy arrays on the
host: the stacked camera matrices, the ground truth as uint8 (a quarter
of float32's bytes; the train step decodes it on the device) and the
timestamps.  The shuffle is ``np.random.RandomState(seed)``, as in the
JAX package, so both see the same batches in the same order.  A batch is
decoded by one call of the native library, on its own threads without the
interpreter lock (per camera where it cannot take the batch whole).
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, List, NamedTuple

import numpy as np

from .. import native
from ..ops.projection import CameraParams
from ..parallel.runtime import host_shard
from .cameras import Camera


class CameraBatch(NamedTuple):
    cams: CameraParams        # numpy leaves stacked [B, ...], float32
    gt: np.ndarray            # [B, 3, H, W] uint8
    timestamps: np.ndarray    # [B, 1, 1] float32
    indices: np.ndarray       # [B]


def stack_camera_params(cams: List[Camera]) -> CameraParams:
    """The cameras' rasterizer parameters stacked on the host."""
    f32 = np.float32
    return CameraParams(
        viewmat=np.stack([c.world_view for c in cams]).astype(f32),
        projmat=np.stack([c.full_proj for c in cams]).astype(f32),
        campos=np.stack([c.camera_center for c in cams]).astype(f32),
        tanfovx=np.asarray([c.tanfovx for c in cams], f32),
        tanfovy=np.asarray([c.tanfovy for c in cams], f32))


class BatchLoader:
    """Endless shuffled batches, ``prefetch`` of them decoded ahead.
    ``close()`` stops the pool.

    ``shard=(i, n)`` gives rank i of n its share of every batch: the
    shuffle and the batches of ``batch_size`` views are every rank's
    alike (one seed), and each rank loads and yields only the views
    ``runtime.host_shard`` deals it, ``batch_size // n`` of them.  The
    shares of a batch are disjoint and together the batch one process
    would load.  The order is a function of the seed alone: the threads
    only decode."""

    def __init__(self, cameras: List[Camera], batch_size: int,
                 white_background: bool = False, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 666, prefetch: int = 4,
                 drop_last: bool = True, shard=(0, 1)):
        if len(cameras) < batch_size:
            raise ValueError(f"{len(cameras)} cameras for batches of "
                             f"{batch_size}")
        if batch_size % shard[1]:
            raise ValueError(f"batches of {batch_size} views do not split "
                             f"among {shard[1]} ranks")
        self.cameras = cameras
        self.batch_size = batch_size
        self.shard = shard
        self.white_background = white_background
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last

    def _load_batch(self, idxs) -> CameraBatch:
        cams = [self.cameras[i] for i in idxs]
        gt = np.stack([x if x.dtype == np.uint8 else
                       np.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
                       for x in self._decode(cams)])
        return CameraBatch(
            cams=stack_camera_params(cams), gt=gt,
            timestamps=np.asarray([c.timestamp for c in cams],
                                  np.float32).reshape(-1, 1, 1),
            indices=np.asarray(idxs))

    def _decode(self, cams: List[Camera]) -> List[np.ndarray]:
        """One native call for the batch when every view is undecoded and
        of one size, else each camera's ``load_image``; a uint8 image
        given to ``set_image`` as it is."""
        if (all(c._image is None and c.image_path for c in cams)
                and len({(c.width, c.height) for c in cams}) == 1
                and native.available()):
            bg = (1.0,) * 3 if self.white_background else (0.0,) * 3
            out = native.load_images([c.image_path for c in cams],
                                     cams[0].width, cams[0].height, bg)
            if out is not None:
                return list(out)
        return [c._image if c._image is not None and c._image.dtype
                == np.uint8 else c.load_image(self.white_background)
                for c in cams]

    def epoch(self) -> Iterator[CameraBatch]:
        order = np.arange(len(self.cameras))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stops = len(order) - bs + 1 if self.drop_last else len(order)
        batches = iter([host_shard(order[i:i + bs], *self.shard)
                        for i in range(0, stops, bs)])
        futures = [self.pool.submit(self._load_batch, b)
                   for _, b in zip(range(self.prefetch), batches)]
        while futures:
            batch = futures.pop(0).result()
            nxt = next(batches, None)
            if nxt is not None:
                futures.append(self.pool.submit(self._load_batch, nxt))
            yield batch

    def __iter__(self):
        while True:
            yield from self.epoch()

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)
