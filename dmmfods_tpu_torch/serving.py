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

Each device batch runs under spans (:mod:`.tracing`, recorded while the
recorder is enabled or a profiler runs): ``engine/take`` (the worker waits
for a request), then ``engine/batch`` holding ``engine/group``,
``engine/pad``, ``engine/h2d``, ``model/forward``, ``engine/device_wait``,
``engine/d2h`` and ``engine/deliver``; each request leaves one
``engine/request`` record. :meth:`InferenceEngine.stats` counts requests,
frames, padded frames and device batches, in total and per bucket, always.
"""

from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from . import tracing

DEFAULT_BUCKETS = (1, 8, 32, 128, 256)

_STOP = object()  # queue sentinel: serve what came before it, then exit


class _Request:
    """A request on the worker's queue; ``id`` and the times (ns on
    :func:`tracing.now`'s clock) are set only while spans are recorded."""

    __slots__ = ("rgb", "lidar", "future", "id", "tid", "submitted", "taken")

    def __init__(self, rgb, lidar, future):
        self.rgb, self.lidar, self.future = rgb, lidar, future
        self.id = self.tid = None
        self.submitted = self.taken = 0


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
        self._requests = 0
        self._per_bucket: dict = {}   # batch size -> [device batches, frames, padded frames]
        self._request_ids = itertools.count(1)

    @property
    def device_batches(self) -> int:
        """Device batches run so far (warm-up included)."""
        return self.stats()["device_batches"]

    def stats(self) -> dict:
        """The engine's counters since it was built: ``requests`` answered,
        ``device_batches`` (warm-up and direct :meth:`forward` calls
        included), the requests' ``frames`` and the ``padded_frames`` added
        to fill their buckets; and each of the last three per bucket, under
        ``buckets``: ``{bucket: {"device_batches", "frames",
        "padded_frames"}}``."""
        with self._count_lock:
            per = {b: dict(device_batches=n, frames=f, padded_frames=p)
                   for b, (n, f, p) in sorted(self._per_bucket.items())}
            requests = self._requests
        return {"requests": requests,
                **{k: sum(v[k] for v in per.values())
                   for k in ("device_batches", "frames", "padded_frames")},
                "buckets": per}

    def _count(self, bucket, batches=0, frames=0, padded=0):
        counts = self._per_bucket.setdefault(bucket, [0, 0, 0])
        counts[0] += batches
        counts[1] += frames
        counts[2] += padded

    @torch.inference_mode()
    def forward(self, rgb: torch.Tensor, lidar: torch.Tensor) -> torch.Tensor:
        """One device batch: NHWC tensors on the engine's device -> heat maps
        on the device (f32 sigmoid with ``decode``, else the logits), from the
        module in eval mode whatever mode a train step left it in. Returns
        once the work is queued on the device, not when it is done."""
        with tracing.span("model/forward"):
            if self._module.training:
                self._module.eval()
            logits = self._module(rgb, None if self._single_stream else lidar)
            out = torch.sigmoid(logits.float()) if self._decode else logits
        with self._count_lock:
            self._count(rgb.shape[0], batches=1)
        return out

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run every bucket once at the configured resolution."""
        h, w = self._hw
        for b in buckets or self._buckets:
            rgb = np.zeros((b, h, w, self._spec.stream_1_in_channels), np.float32)
            lidar = np.zeros((b, h, w, self._lidar_channels), np.float32)
            self.forward(self._to_device(rgb), self._to_device(lidar))
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

    def _to_device(self, arr):
        """Copy a host batch and cast it to the compute dtype on the device."""
        return torch.from_numpy(arr).to(self._device).to(self._spec.dtype)

    def _fill_lidar(self, rgb, lidar):
        if lidar is None:
            return np.zeros(rgb.shape[:3] + (self._lidar_channels,), np.float32)
        return np.asarray(lidar, np.float32)

    def _done_event(self):
        """A CUDA event after the work queued so far, while spans are
        recorded: waiting on it apart from the copy splits the device wait
        from the copy (``engine/device_wait``). Else ``None``."""
        if self._device.type != "cuda" or not tracing.enabled():
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        return event

    def _score(self, rgb, lidar, batch=tracing.NOOP):
        """Heat maps for any number of frames, one host array per chunk of
        at most the largest bucket, each chunk padded to its bucket. Every
        chunk is queued on the device before the first result is copied
        back. ``batch`` is the open ``engine/batch`` span, given the
        buckets, frames and padded frames."""
        max_bucket = self._buckets[-1]
        with tracing.span("engine/pad"):
            rgb = np.asarray(rgb, np.float32)
            lidar = self._fill_lidar(rgb, lidar)
            chunks = []
            for start in range(0, rgb.shape[0], max_bucket):
                r, li = rgb[start:start + max_bucket], lidar[start:start + max_bucket]
                bucket = self._bucket_for(r.shape[0])
                chunks.append((self._pad(r, bucket), self._pad(li, bucket), r.shape[0]))
        if batch is not tracing.NOOP:
            batch.set(buckets=tuple(r.shape[0] for r, _, _ in chunks), frames=rgb.shape[0],
                      padded=sum(r.shape[0] - n for r, _, n in chunks))
        pending = []
        for r, li, n in chunks:
            with tracing.span("engine/h2d"):
                r, li = self._to_device(r), self._to_device(li)
            pending.append((self.forward(r, li), n, self._done_event()))
        outs = []
        for out, n, done in pending:
            if done is not None:
                with tracing.span("engine/device_wait"):
                    done.synchronize()
            with tracing.span("engine/d2h"):
                outs.append(out[:n].float().cpu().numpy())
        with self._count_lock:
            for (r, _, n) in chunks:
                self._count(r.shape[0], frames=n, padded=r.shape[0] - n)
        return outs

    def run(self, rgb, lidar=None):
        """Synchronous scoring of one request of any batch size."""
        request = self._stamp(_Request(None, None, None))
        with tracing.span("engine/batch") as batch:
            if request.id is not None:
                batch.set(requests=(request.id,))
            outs = self._score(rgb, lidar, batch)
            with tracing.span("engine/deliver"):
                out = np.concatenate(outs, axis=0)
        with self._count_lock:
            self._requests += 1
        if request.id is not None:
            request.taken = request.submitted
            self._record(request, out.shape[0])
        return out

    def submit(self, rgb, lidar=None) -> Future:
        """Asynchronous scoring; returns a ``Future`` of the heat maps.
        Requests may be queued before :meth:`start`; they are served once the
        worker runs."""
        future: Future = Future()
        rgb = np.asarray(rgb, np.float32)
        self._queue.put(self._stamp(_Request(rgb, self._fill_lidar(rgb, lidar), future)))
        return future

    def _stamp(self, request):
        """While spans are recorded, give ``request`` an id, the calling
        thread and its submit time."""
        if tracing.enabled():
            request.id, request.tid = next(self._request_ids), threading.get_ident()
            request.submitted = tracing.now()
        return request

    @staticmethod
    def _record(request, frames):
        tracing.record("engine/request", request.submitted, tracing.now(), tid=request.tid,
                       id=request.id, frames=frames, taken=request.taken)

    def _worker(self):
        held = None  # a request taken from the queue that opens the next group
        while True:
            if held is None:
                with tracing.span("engine/take"):
                    first = self._queue.get()
                _taken(first)
            else:
                first, held = held, None
            if first is _STOP:
                return
            with tracing.span("engine/batch") as batch:
                held = self._serve(first, batch)

    def _serve(self, first, batch):
        """Coalesce waiting requests of ``first``'s frame shape until the
        largest bucket is full, score them as one group and give each
        request its slice; returns the request taken that opens the next
        group (``None`` if none was)."""
        group, held = [first], None
        try:
            with tracing.span("engine/group"):
                total = first.rgb.shape[0]
                while total < self._buckets[-1]:
                    try:
                        item = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    _taken(item)
                    if item is _STOP or item.rgb.shape[1:] != first.rgb.shape[1:]:
                        held = item
                        break
                    group.append(item)
                    total += item.rgb.shape[0]
                rgb = np.concatenate([r.rgb for r in group], axis=0)
                lidar = np.concatenate([r.lidar for r in group], axis=0)
            if batch is not tracing.NOOP:
                batch.set(requests=tuple(r.id for r in group))
            outs = self._score(rgb, lidar, batch)
        except Exception as exc:  # a bad request fails its own futures only
            for r in group:
                r.future.set_exception(exc)
            return held
        with tracing.span("engine/deliver"):
            out = np.concatenate(outs, axis=0)
            start = 0
            for r in group:
                n = r.rgb.shape[0]
                r.future.set_result(out[start:start + n])
                start += n
                if r.id is not None:
                    self._record(r, n)
        with self._count_lock:
            self._requests += len(group)
        return held


def _taken(item):
    """Stamp a traced request with the time the worker took it."""
    if item is not _STOP and item.id is not None:
        item.taken = tracing.now()
