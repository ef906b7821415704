"""Batched inference engine: the port of ``dmmfods_tpu/serving.py``.

* Requests are padded up to the nearest batch bucket, so the device only
  ever sees the bucket shapes; :meth:`InferenceEngine.warmup` runs each
  bucket once ahead of serving (it also builds the CUDA kernels).
* A worker thread coalesces waiting requests of one frame shape into one
  device batch, so a load of small requests rides the large-batch rate.
* Outputs are heat maps; ``decode=True`` applies the sigmoid on the device
  before the copy to the host.

Usage::

    engine = InferenceEngine(bundle)           # a ModelBundle on the card
    engine.warmup()
    engine.start()
    heatmaps = engine.submit(rgb_frames, lidar_frames).result()
    engine.stop()

Synchronous batch scoring: ``engine.run(rgb, lidar)``. Frames are NHWC
numpy arrays, as for the JAX engine.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

DEFAULT_BUCKETS = (1, 8, 32, 128, 256)

_STOP = object()  # queue sentinel: serve what came before it, then exit


class InferenceEngine:
    """Serves ``bundle.module`` on the device its parameters live on."""

    def __init__(self, bundle, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 decode: bool = True, height: Optional[int] = None,
                 width: Optional[int] = None):
        if not buckets or min(buckets) < 1:
            raise ValueError(f"buckets must be positive batch sizes, got {buckets}")
        self._module = bundle.module.eval()
        self._spec = bundle.spec
        self._device = bundle.device
        self._buckets = tuple(sorted(buckets))
        self._decode = decode
        if height is None or width is None:
            # config.dataset.images.size is (C, W, H), as in the reference
            _, width, height = bundle.config.dataset.images.size
        self._hw = (height, width)
        self._single_stream = self._spec.stream_2_in_channels == 0
        self._lidar_channels = max(self._spec.stream_2_in_channels, 1)
        self._queue: queue.Queue = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._count_lock = threading.Lock()
        self._device_batches = 0

    @property
    def device_batches(self) -> int:
        """Device batches run so far (warm-up included)."""
        return self._device_batches

    @torch.inference_mode()
    def forward(self, rgb: torch.Tensor, lidar: torch.Tensor) -> torch.Tensor:
        """One device batch: NHWC tensors on the engine's device -> heat maps
        on the device (f32 sigmoid with ``decode``, else the logits), from the
        module in eval mode whatever mode a train step left it in. Returns
        once the work is queued on the device, not when it is done."""
        if self._module.training:
            self._module.eval()
        logits = self._module(rgb, None if self._single_stream else lidar)
        with self._count_lock:
            self._device_batches += 1
        return torch.sigmoid(logits.float()) if self._decode else logits

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run every bucket once at the configured resolution."""
        h, w = self._hw
        for b in buckets or self._buckets:
            rgb = np.zeros((b, h, w, self._spec.stream_1_in_channels), np.float32)
            lidar = np.zeros((b, h, w, self._lidar_channels), np.float32)
            self.forward(self._to_device(rgb, b), self._to_device(lidar, b))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def start(self):
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def stop(self):
        """Serve every request submitted so far, then stop the worker."""
        self._queue.put(_STOP)
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- scoring -----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    @staticmethod
    def _pad(arr, bucket):
        n = arr.shape[0]
        if n == bucket:
            return arr
        pad = np.zeros((bucket - n,) + arr.shape[1:], arr.dtype)
        return np.concatenate([arr, pad], axis=0)

    def _to_device(self, arr, bucket):
        """Pad on the host, copy, and cast to the compute dtype on the device."""
        return torch.from_numpy(self._pad(arr, bucket)).to(self._device).to(
            self._spec.dtype)

    def _fill_lidar(self, rgb, lidar):
        if lidar is None:
            return np.zeros(rgb.shape[:3] + (self._lidar_channels,), np.float32)
        return np.asarray(lidar, np.float32)

    def _score(self, rgb, lidar):
        """Heat maps for any number of frames: chunks of at most the largest
        bucket, each padded to its bucket. Every chunk is queued on the
        device before the first result is copied back."""
        max_bucket = self._buckets[-1]
        pending = []
        for start in range(0, rgb.shape[0], max_bucket):
            r = rgb[start:start + max_bucket]
            bucket = self._bucket_for(r.shape[0])
            out = self.forward(self._to_device(r, bucket),
                               self._to_device(lidar[start:start + max_bucket], bucket))
            pending.append((out, r.shape[0]))
        return np.concatenate(
            [out[:n].float().cpu().numpy() for out, n in pending], axis=0)

    def run(self, rgb, lidar=None):
        """Synchronous scoring of one request of any batch size."""
        rgb = np.asarray(rgb, np.float32)
        return self._score(rgb, self._fill_lidar(rgb, lidar))

    def submit(self, rgb, lidar=None) -> Future:
        """Asynchronous scoring; returns a ``Future`` of the heat maps.
        Requests may be queued before :meth:`start`; they are served once the
        worker runs."""
        future: Future = Future()
        rgb = np.asarray(rgb, np.float32)
        self._queue.put((rgb, self._fill_lidar(rgb, lidar), future))
        return future

    def _worker(self):
        held = None  # a request taken from the queue that opens the next group
        while True:
            first = held if held is not None else self._queue.get()
            held = None
            if first is _STOP:
                return
            # coalesce waiting requests of the same frame shape until the
            # largest bucket is full; anything else opens the next group
            group, total = [first], first[0].shape[0]
            while total < self._buckets[-1]:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP or item[0].shape[1:] != first[0].shape[1:]:
                    held = item
                    break
                group.append(item)
                total += item[0].shape[0]
            self._serve(group)

    def _serve(self, group):
        try:
            out = self._score(np.concatenate([g[0] for g in group], axis=0),
                              np.concatenate([g[1] for g in group], axis=0))
        except Exception as exc:  # a bad request fails its own futures only
            for _, _, future in group:
                future.set_exception(exc)
            return
        start = 0
        for rgb, _, future in group:
            future.set_result(out[start:start + rgb.shape[0]])
            start += rgb.shape[0]
