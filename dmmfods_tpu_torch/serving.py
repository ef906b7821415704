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

The engine copies to and from the device only through f32 host blocks
that it owns and reuses, page-locked on a CUDA device (on the CPU the same
logic runs over ordinary memory):

* Input staging: one block per input (RGB, LiDAR) and frame shape, of the
  largest bucket run at that shape, made at first use and grown only when
  a larger bucket comes. Each request's frames are written straight into
  it at their offsets and the pad rows zeroed (``engine/pad``), then its
  rows are copied to the device without waiting and cast there
  (``engine/h2d``). The block is written again only once that copy is done
  (a CUDA event): a call of more frames than the largest bucket stages its
  chunks one after another through it.
* Results on loan: per output frame shape, at most ``RESULT_BLOCKS``
  blocks of the largest bucket run. A call of one chunk has its heat maps
  copied into a free block (``engine/d2h``, which waits for the copy) and
  gets a numpy view of it (``engine/deliver``; the worker gives each
  request its slice of that view). The block goes back to the pool when
  the last view of it dies, whichever thread drops it.
* Copy-out: where every block is on loan, or the call has more frames
  than the largest bucket, each chunk's heat maps go through one staging
  block that is never lent and are written once into a fresh array that
  the caller owns.

Each device batch runs under spans (:mod:`.tracing`, recorded while the
recorder is enabled or a profiler runs): ``engine/take`` (the worker waits
for a request), then ``engine/batch`` holding ``engine/group``,
``engine/pad``, ``engine/h2d``, ``model/forward``, ``engine/device_wait``,
``engine/d2h`` (attribute ``lent``: whether the heat maps went into a
block on loan) and ``engine/deliver``; a call of several chunks repeats
``engine/pad``, ``engine/h2d`` and ``model/forward`` for each chunk, then
``engine/device_wait`` and ``engine/d2h``. Each request leaves one
``engine/request`` record. :meth:`InferenceEngine.stats` counts requests,
frames, padded frames, device batches, results lent and results copied
out, and the bytes of the engine's host blocks, in total and per bucket,
always.
"""

from __future__ import annotations

import collections
import functools
import itertools
import queue
import threading
import weakref
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from . import tracing

DEFAULT_BUCKETS = (1, 8, 32, 128, 256)
# result blocks per output frame shape: a caller holds its last answer while
# it asks for the next, so one is not enough
RESULT_BLOCKS = 4

_STOP = object()  # queue sentinel: serve what came before it, then exit
# the per-bucket counters of InferenceEngine.stats(), in _count's order
_COUNTS = ("device_batches", "frames", "padded_frames", "results_lent", "results_copied")


class _Request:
    """A request on the worker's queue; ``id`` and the times (ns on
    :func:`tracing.now`'s clock) are set only while spans are recorded."""

    __slots__ = ("rgb", "lidar", "future", "id", "tid", "submitted", "taken")

    def __init__(self, rgb, lidar, future):
        self.rgb, self.lidar, self.future = rgb, lidar, future
        self.id = self.tid = None
        self.submitted = self.taken = 0


class _Loans:
    """The result blocks of one output frame shape: at most
    ``RESULT_BLOCKS``, each of the largest bucket taken so far, free or lent
    to a caller as a numpy view.

    A lent view's finalizer puts its block on ``back`` from whatever thread
    drops the last view. ``deque.append`` is atomic, so the finalizer takes
    no lock: a lock there could be one that the dropping thread already
    holds. :meth:`take` puts those blocks back among the free ones."""

    def __init__(self):
        self.rows = 0
        self.blocks = []                  # every block held, free or lent
        self.free = []
        self.back = collections.deque()   # lent blocks whose views are gone

    def take(self, rows, new):
        """A free block of at least ``rows`` rows; else, while fewer than
        ``RESULT_BLOCKS`` are held, a new one of the largest bucket taken
        (``new(rows)``); else ``None``. A block smaller than that bucket is
        let go once it is free."""
        self.rows = max(self.rows, rows)
        while self.back:
            self.free.append(self.back.popleft())
        small = [b for b in self.free if b.shape[0] < self.rows]
        if small:
            self.free = [b for b in self.free if b.shape[0] >= self.rows]
            self.blocks = [b for b in self.blocks if all(b is not s for s in small)]
        if self.free:
            return self.free.pop()
        if len(self.blocks) < RESULT_BLOCKS:
            self.blocks.append(new(self.rows))
            return self.blocks[-1]
        return None

    def lend(self, block, n):
        """The first ``n`` rows of ``block`` as a numpy array; the block
        comes back once that array and every numpy view of it are gone (a
        view keeps it as its ``base``; a fancy-indexed copy does not)."""
        view = block[:n].numpy()
        weakref.finalize(view, self.back.append, block)
        return view


class _HostBlocks:
    """The f32 host blocks an engine on ``device`` copies through: page-locked
    on a CUDA device, ordinary memory on the CPU. ``lock`` is held from a
    chunk's staging until its copy to the device is queued, while a result
    block is taken, and over a copy-out, since the worker and a caller of
    ``run`` may score at once."""

    def __init__(self, device):
        self.device = device
        self.lock = threading.Lock()
        self._inputs = {}    # (input, frame shape) -> [block, event after its last upload]
        self._staging = {}   # output frame shape -> the copy-out block (never lent)
        self._loans = {}     # output frame shape -> _Loans

    def _new(self, rows, shape):
        return torch.empty((rows,) + tuple(shape), dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")

    def stage(self, key, arrays, start, n, rows):
        """The input block of ``key`` (input, frame shape), its first ``rows``
        rows holding frames ``start`` to ``start + n`` of ``arrays`` joined
        along the batch, then zeros. Waits for the block's last copy to the
        device before writing it; grows it where it has fewer rows."""
        slot = self._inputs.get(key)
        if slot is None or slot[0].shape[0] < rows:
            slot = self._inputs[key] = [self._new(rows, key[1]), None]
        elif slot[1] is not None:
            slot[1].synchronize()
        block = slot[0][:rows]
        row = offset = 0
        for a in arrays:
            lo, hi = max(start - offset, 0), min(start + n - offset, a.shape[0])
            if lo < hi:
                block[row:row + hi - lo].copy_(torch.from_numpy(a[lo:hi]))
                row += hi - lo
            offset += a.shape[0]
        block[n:].zero_()
        return block

    def uploaded(self, keys):
        """The input blocks of ``keys`` are in flight until the work queued
        so far on the current stream is done."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            for key in keys:
                self._inputs[key][1] = event

    def take(self, shape, rows):
        """A result block of ``rows`` rows or more for frames of ``shape``,
        or ``None`` where every block is on loan (:meth:`_Loans.take`)."""
        loans = self._loans.setdefault(shape, _Loans())
        return loans.take(rows, lambda r: self._new(r, shape))

    def lend(self, shape, block, n):
        return self._loans[shape].lend(block, n)

    def staging(self, shape, rows):
        """The copy-out block for frames of ``shape``, of at least ``rows``
        rows."""
        block = self._staging.get(shape)
        if block is None or block.shape[0] < rows:
            block = self._staging[shape] = self._new(rows, shape)
        return block

    def blocks(self):
        """Every block held: input, copy-out and result blocks, lent ones
        included."""
        with self.lock:
            return ([b for b, _ in self._inputs.values()] + list(self._staging.values())
                    + [b for loans in self._loans.values() for b in loans.blocks])


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
        self._per_bucket: dict = {}   # batch size -> counts, in _COUNTS' order
        self._host = _HostBlocks(self._device)
        self._request_ids = itertools.count(1)

    @property
    def device_batches(self) -> int:
        """Device batches run so far (warm-up included)."""
        return self.stats()["device_batches"]

    def stats(self) -> dict:
        """The engine's counters since it was built: ``requests`` answered,
        ``device_batches`` (warm-up and direct :meth:`forward` calls
        included), the requests' ``frames``, the ``padded_frames`` added
        to fill their buckets, ``results_lent`` (device batches whose heat
        maps went to the caller as a view of a result block on loan),
        ``results_copied`` (device batches copied out into a fresh array:
        every block on loan, or a call past the largest bucket) and
        ``pinned_bytes`` (the bytes of the engine's host blocks, page-locked
        on a CUDA device, ordinary memory on the CPU: input, copy-out and
        result blocks, lent ones included); and each of them per bucket,
        under ``buckets``: ``{bucket: {"device_batches", "frames",
        "padded_frames", "results_lent", "results_copied",
        "pinned_bytes"}}``, a block counted under the bucket it is sized
        for. Lent over lent and copied results is the share of batches
        whose heat maps took no copy on the host."""
        pinned = collections.Counter()
        for block in self._host.blocks():
            pinned[block.shape[0]] += block.nbytes
        with self._count_lock:
            counts = {b: list(c) for b, c in self._per_bucket.items()}
            requests = self._requests
        per = {b: dict(zip(_COUNTS, counts.get(b, [0] * len(_COUNTS))), pinned_bytes=pinned[b])
               for b in sorted(counts.keys() | pinned.keys())}
        return {"requests": requests,
                **{k: sum(v[k] for v in per.values()) for k in _COUNTS + ("pinned_bytes",)},
                "buckets": per}

    def _count(self, bucket, *added):
        """Add ``added`` to ``bucket``'s counters, in ``_COUNTS``' order."""
        counts = self._per_bucket.setdefault(bucket, [0] * len(_COUNTS))
        for i, k in enumerate(added):
            counts[i] += k

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
            self._count(rgb.shape[0], 1)
        return out

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None):
        """Run every bucket once at the configured resolution on zeros
        staged through the input blocks, the largest bucket first, so that
        the blocks are made once, at their full size."""
        h, w = self._hw
        keys = (("rgb", (h, w, self._spec.stream_1_in_channels)),
                ("lidar", (h, w, self._lidar_channels)))
        for b in sorted(buckets or self._buckets, reverse=True):
            with self._host.lock:
                inputs = self._upload(keys, [self._host.stage(k, (), 0, 0, b) for k in keys])
            self.forward(*inputs)
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

    def _plan(self, parts):
        """``parts`` as f32 arrays with their LiDAR filled, checked to share
        their frame shapes; the chunks ``[(start, frames, bucket), ...]`` of
        at most the largest bucket that cover their frames; and the number
        of frames."""
        parts = [(rgb, self._fill_lidar(rgb, lidar))
                 for rgb, lidar in ((np.asarray(r, np.float32), li) for r, li in parts)]
        rgb0, lidar0 = parts[0]
        for rgb, lidar in parts:
            if (rgb.ndim != 4 or rgb.shape[1:] != rgb0.shape[1:]
                    or lidar.shape[1:] != lidar0.shape[1:] or lidar.shape[0] != rgb.shape[0]):
                raise ValueError(f"frames of one batch must be NHWC of one shape per input; got "
                                 f"{rgb.shape} and {lidar.shape} beside {rgb0.shape} and "
                                 f"{lidar0.shape}")
        total, step = sum(rgb.shape[0] for rgb, _ in parts), self._buckets[-1]
        if total == 0:
            raise ValueError("a request needs at least one frame")
        sizes = [(start, min(step, total - start)) for start in range(0, total, step)]
        return parts, [(start, n, self._bucket_for(n)) for start, n in sizes], total

    def _upload(self, keys, blocks):
        """Copy staged input blocks to the device without waiting and cast
        them to the compute dtype there; the blocks of ``keys`` are written
        again only once the copy is done."""
        out = [b.to(self._device, non_blocking=True).to(self._spec.dtype) for b in blocks]
        self._host.uploaded(keys)
        return out

    def _fetch(self, host, out):
        """Copy the device rows ``out`` into the host rows ``host`` and wait
        for the copy."""
        host.copy_(out, non_blocking=True)
        if self._device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self._device))
            event.synchronize()

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

    def _score(self, parts, batch=tracing.NOOP):
        """Heat maps for the frames of ``parts``, ``[(rgb, lidar), ...]`` in
        order (NHWC, any number of frames each; ``lidar`` may be ``None``),
        in chunks of at most the largest bucket, each padded to its bucket.
        Every chunk is queued on the device before the first result is
        copied back. Returns a function that hands the heat maps over as one
        f32 array: for a call of one chunk, a view of a result block on loan
        where one is free; else a fresh array. ``batch`` is the open
        ``engine/batch`` span, given the buckets, frames and padded
        frames."""
        pending, plan = [], None
        while plan is None or len(pending) < len(plan):
            with self._host.lock:
                with tracing.span("engine/pad"):
                    if plan is None:     # the first chunk's pad also converts the input
                        parts, plan, total = self._plan(parts)
                        batch.set(buckets=tuple(b for _, _, b in plan), frames=total,
                                  padded=sum(b - n for _, n, b in plan))
                        keys = (("rgb", parts[0][0].shape[1:]), ("lidar", parts[0][1].shape[1:]))
                    start, n, bucket = plan[len(pending)]
                    blocks = [self._host.stage(key, [p[i] for p in parts], start, n, bucket)
                              for i, key in enumerate(keys)]
                with tracing.span("engine/h2d"):
                    inputs = self._upload(keys, blocks)
            pending.append((self.forward(*inputs), start, n, bucket, self._done_event()))
        answer = block = None
        for out, start, n, bucket, done in pending:
            if done is not None:
                with tracing.span("engine/device_wait"):
                    done.synchronize()
            with tracing.span("engine/d2h") as d2h:
                out = out[:n].float()
                shape = tuple(out.shape[1:])
                if len(pending) == 1:
                    with self._host.lock:
                        block = self._host.take(shape, bucket)
                d2h.set(lent=block is not None)
                if block is not None:
                    self._fetch(block[:n], out)
                    continue
                if answer is None:
                    answer = np.empty((total,) + shape, np.float32)
                with self._host.lock:
                    staging = self._host.staging(shape, bucket)[:n]
                    self._fetch(staging, out)
                    torch.from_numpy(answer[start:start + n]).copy_(staging)
        with self._count_lock:
            for _, _, n, bucket, _ in pending:
                self._count(bucket, 0, n, bucket - n, int(block is not None),
                            int(block is None))
        if block is not None:
            return functools.partial(self._host.lend, shape, block, n)
        return lambda: answer

    def run(self, rgb, lidar=None):
        """Synchronous scoring of one request of any batch size."""
        request = self._stamp(_Request(None, None, None))
        with tracing.span("engine/batch") as batch:
            if request.id is not None:
                batch.set(requests=(request.id,))
            answer = self._score([(rgb, lidar)], batch)
            with tracing.span("engine/deliver"):
                out = answer()
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
            first = None   # an answered request holds its heat maps: let them go

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
            if batch is not tracing.NOOP:
                batch.set(requests=tuple(r.id for r in group))
            answer = self._score([(r.rgb, r.lidar) for r in group], batch)
        except Exception as exc:  # a bad request fails its own futures only
            for r in group:
                r.future.set_exception(exc)
            return held
        with tracing.span("engine/deliver"):
            out = answer()
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
