"""The loops that drive the program, one per kind of traffic, and what each
hands the correctness check.

* ``score``: offline scoring, a closed loop of one caller: ``engine.run`` on
  host batches from a seeded pool, the next call when the last returns.
* ``stream``: requests from a fixed number of clients, a closed loop:
  ``engine.submit`` with the engine's worker started, each client sending
  its next request (sizes and frames drawn from the seed) when its last
  one's answer is back; the frames that came back by the window's close
  are counted. The requests still out at the close (one a client at most)
  are waited for and judged like the others.

Each loop builds the program once in :meth:`Loop.setup` (the model, the
seeded weights, the warm-up of the cell's shapes), runs one window in
:meth:`Loop.window`, and after :meth:`Loop.release` has freed the program's
state gives the check its readings: the program's answers beside the plain
reference's (:meth:`Loop.readings`), or the control's beside the reference
(:meth:`Loop.control_readings`). What a model is, what its answers hold and
how they are judged is the cell's model family's (``cell.family``, see
``gpubench/spec.py``): no code here names one. With tracing on,
``torch.profiler`` records the last ``TRACE_SECONDS`` of the window; a
stream cell's profiler stops only once the requests out at the close are
back and the engine's worker has stopped, since stopping it while another
thread drives the device can crash the process.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import math
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import inputs
from . import trace as tr

TRACE_SECONDS = 3.0
CLOSE_WAIT_SECONDS = 60.0  # how long a request out at the close may take past it

def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RunRecord:
    """What one window gave: the metric readers' input."""
    cell: object
    loop: str
    window_s: float
    attempted: int
    failed: int
    frames: int
    setup_s: float = float("nan")
    # host seconds of each engine.forward call of the window (with tracing
    # on, of those begun before the traced slice)
    forward_host_s: list = dataclasses.field(default_factory=list)
    # each engine.forward call's kernel launches, {"K1": n, ...} (the
    # family's counters), in order
    forward_launches: list = dataclasses.field(default_factory=list)
    device_batches: int = 0
    forwards_traced: int = 0      # engine.forward calls begun in the traced slice
    trace: Optional[tr.Trace] = None
    flops_per_frame: float = 0.0
    frames_in_window: int = 0     # stream: frames whose answers came back by the close
    seconds: float = 0.0          # the window's nominal length
    notes: list = dataclasses.field(default_factory=list)


class Tracer:
    """``torch.profiler`` over a slice of the window, bracketed by the
    ``gpubench/window`` range, which :meth:`close` ends; :meth:`stop` exits
    the profiler and gives the reduced trace and the offset from
    ``time.perf_counter`` to the profiler's clock."""

    def __init__(self, device):
        self.device = device
        self.on = False
        self.prof = self.span = None

    def _profile(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self):
        """Start and stop the profiler once, so that its first start (which
        takes up to seconds) falls in set-up and not in the window."""
        with self._profile():
            torch.zeros(1, device=self.device).add_(1)
            sync(self.device)

    def start(self):
        self.prof = self._profile()
        self.prof.__enter__()
        self.t_start = time.perf_counter()
        self.span = record_function(tr.WINDOW_SPAN)
        self.span.__enter__()
        self.on = True

    def close(self):
        """End the traced slice: wait for the device, then close the
        ``gpubench/window`` range. The profiler records on until
        :meth:`stop`; the readers read the slice alone."""
        sync(self.device)
        self.span.__exit__(None, None, None)
        self.span = None

    def stop(self):
        """Exit the profiler (closing the slice first if :meth:`close` has
        not)."""
        if self.span is not None:
            self.close()
        self.prof.__exit__(None, None, None)
        self.on = False
        trace = tr.reduce_events(self.prof.events())
        self.prof = None
        return trace, trace.window[0] - self.t_start


class Loop:
    kind = ""

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.traffic, self.arch, self.family = cell.traffic, cell.arch, cell.family
        self.parts = {}           # set-up seconds by part
        self.t_window = None      # perf_counter at the window's start

    def _part(self, name, fn):
        t = time.perf_counter()
        out = fn()
        sync(self.device)
        self.parts[name] = self.parts.get(name, 0.0) + time.perf_counter() - t
        return out

    def build(self):
        """The program's model, as the family builds it, with the seeded
        weights loaded."""
        self.bundle = self._part("model", lambda: self.family.build(self.cell.config,
                                                                    self.device))
        self.state_dict = self._part("weights", lambda: self.family.make_state_dict(
            self.arch, self.seed, self.device))
        self._part("weights", lambda: self.bundle.module.load_state_dict(self.state_dict))

    def reference(self, quant=None):
        """The family's plain reference on the run's device, with the seeded
        weights."""
        with torch.device("meta"):
            net = self.family.reference(self.arch, quant)
        net = net.to_empty(device=self.device)
        net.load_state_dict(self.state_dict)
        return net

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("engine", "bundle"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()         # the engine's forward wrapper holds the engine in a cycle
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class ServingLoop(Loop):
    """The engine over the program's model, its buckets warmed, with a
    host-clock wrapper around ``engine.forward``."""

    def setup(self, seconds):
        from dmmfods_tpu_torch.serving import InferenceEngine
        from dmmfods_tpu_torch.ops import _build

        t = self.traffic
        self.build()
        self.engine = InferenceEngine(self.bundle, buckets=t["buckets"], height=t["height"],
                                      width=t["width"])
        self.make_inputs(seconds)
        self._part("warmup", self.warm)
        if _build.build_seconds is not None:
            self.parts["build"] = _build.build_seconds
            self.parts["warmup"] -= _build.build_seconds
        self.forward_calls = []
        orig, launches = self.engine.forward, self.family.counters()

        def forward(rgb, lidar):
            # one thread calls it at a time (the caller, or the engine's
            # worker), so the counters' change is this call's launches
            before = {k: c.value for k, c in launches.items()}
            t0 = time.perf_counter()
            with record_function("gpubench/engine.forward"):
                out = orig(rgb, lidar)
            self.forward_calls.append((t0, time.perf_counter(), {
                k: c.value - before[k] for k, c in launches.items()}))
            return out

        self.engine.forward = forward

    def host_frames(self, n, stream=inputs.FRAMES):
        t = self.traffic
        rgb, lidar = inputs.make_frames(self.seed, n, t["height"], t["width"], self.device,
                                        stream)
        return rgb.cpu().numpy(), lidar.cpu().numpy()

    def record(self, window_s, attempted, failed, frames, batches0, tracer_out,
               close=math.inf):
        """The window's record; ``engine.forward`` calls begun from its
        start until ``close`` are its calls."""
        calls = [c for c in self.forward_calls if self.t_window <= c[0] < close]
        rec = RunRecord(cell=self.cell, loop=self.kind, window_s=window_s, attempted=attempted,
                        failed=failed, frames=frames,
                        forward_host_s=[e - s for s, e, _ in calls],
                        forward_launches=[n for _, _, n in calls],
                        device_batches=self.engine.device_batches - batches0,
                        flops_per_frame=self.family.flops_per_frame(
                            self.arch, self.traffic["height"], self.traffic["width"]))
        rec.notes.append(f"{rec.flops_per_frame} operations a frame, forward, from shapes")
        if tracer_out is not None:
            rec.trace, offset = tracer_out
            lo, hi = (t - offset for t in rec.trace.window)
            rec.forwards_traced = sum(1 for s, _, _ in calls if lo <= s < hi)
            # the profiler slows the host's enqueue: time it outside the slice
            rec.forward_host_s = [e - s for s, e, _ in calls if s < lo]
            # the profiler records no range of the engine's worker thread:
            # label the device's idle gaps by the benchmark's host clock
            if self.kind == "stream":
                rec.trace.host = sorted(rec.trace.host + [
                    (s + offset, e + offset, "gpubench/engine.forward")
                    for s, e, _ in calls])
        return rec

    def readings(self):
        """``{request: (program answer, reference answer)}`` for every kept
        answer, the reference in float32."""
        ref = self.reference_answers(None)
        return {k: (v, ref[k]) for k, v in self.kept.items()}

    def control_readings(self):
        """The control in the program's place: the family's reference in its
        lower precision on the same requests, beside the float32 reference."""
        ref, ctl = self.reference_answers(None), self.reference_answers("fp8")
        return {k: (ctl[k], ref[k]) for k in self.kept}

    def reference_units(self):
        """The distinct inputs the kept answers hold: ``{unit: (rgb, lidar)}``."""
        return {k: self.inputs_of(k) for k in self.kept}

    def assemble(self, answers, rows):
        """Each kept answer's reference from ``answers``, the reference's
        answer over every unit's frames, of which unit ``k`` holds rows
        ``rows[k]``."""
        return {k: self.family.take(answers, r) for k, r in rows.items()}

    def reference_answers(self, quant):
        net = self.reference(quant).eval()
        units = self.reference_units()
        keys = sorted(units)
        rgb = np.concatenate([units[k][0] for k in keys])
        lidar = np.concatenate([units[k][1] for k in keys])
        answers = self.family.reference_answers(net, rgb, lidar, self.traffic["reference_chunk"])
        del net
        rows, start = {}, 0
        for k in keys:
            n = units[k][0].shape[0]
            rows[k] = range(start, start + n)
            start += n
        return self.assemble(answers, rows)

    def numbers(self, pairs):
        return self.family.numbers(pairs)


class ScoreLoop(ServingLoop):
    kind = "score"

    def make_inputs(self, seconds):
        t = self.traffic
        b, n = t["batch"], t["pool_batches"]
        rgb, lidar = self._part("inputs", lambda: self.host_frames(n * b))
        self.pool = [(rgb[i * b:(i + 1) * b], lidar[i * b:(i + 1) * b]) for i in range(n)]

    def warm(self):
        self.engine.warmup()
        self.engine.run(*self.pool[0])

    def window(self, seconds, trace):
        engine, n_pool = self.engine, len(self.pool)
        keep_each = self.traffic["kept_frames_per_call"]
        tracer = Tracer(self.device) if trace else None
        kept, calls, frames, failed = {}, 0, 0, 0
        batches0 = engine.device_batches
        self.t_window = t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if tracer and not tracer.on and time.perf_counter() - t0 >= seconds - TRACE_SECONDS:
                tracer.start()
            p = calls % n_pool
            try:
                with record_function("gpubench/engine.run"):
                    out = engine.run(*self.pool[p])
            except Exception as exc:      # a failed call counts; the run goes on
                failed += 1
                print(f"call {calls} failed: {exc!r}", file=sys.stderr, flush=True)
            else:
                n = self.family.frames(out)
                frames += n
                idx = tuple(inputs.pick(self.seed + calls, n, keep_each))
                kept[(p, idx, calls)] = self.family.take(out, idx)
            calls += 1
        window_s = time.perf_counter() - t0
        tracer_out = tracer.stop() if tracer else None
        self.kept = kept
        return self.record(window_s, calls, failed, frames, batches0, tracer_out)

    def reference_units(self):
        """Each pool frame that a kept answer holds, once."""
        frames = sorted({(p, f) for p, idx, _ in self.kept for f in idx})
        return {(p, f): (self.pool[p][0][f:f + 1], self.pool[p][1][f:f + 1])
                for p, f in frames}

    def assemble(self, answers, rows):
        return {(p, idx, c): self.family.take(answers, [rows[(p, f)][0] for f in idx])
                for p, idx, c in self.kept}


class StreamLoop(ServingLoop):
    kind = "stream"

    def make_inputs(self, seconds):
        n_pool = self.traffic["pool_frames"]
        self.rgb, self.lidar = self._part("inputs", lambda: self.host_frames(n_pool))

    def warm(self):
        """Every bucket, then each request size through the worker, twice."""
        self.engine.warmup()
        self.engine.start()
        for _ in range(2):
            futures = [self.engine.submit(self.rgb[:k], self.lidar[:k])
                       for k in sorted(set(self.traffic["frames_per_request"]))]
            for f in futures:
                f.result()

    def inputs_of(self, i):
        o, k = self.spans[i]
        return self.rgb[o:o + k], self.lidar[o:o + k]

    def window(self, seconds, trace):
        """``clients`` callers, each submitting its next request when its
        last one's answer is back, until the close; the requests still out
        at the close are waited for (at most ``CLOSE_WAIT_SECONDS``). With
        tracing on, the traced slice ends at the close, and the profiler
        stops after that wait and the worker's stop."""
        t, engine = self.traffic, self.engine
        tracer = Tracer(self.device) if trace else None
        requests = inputs.Requests(self.seed, t["frames_per_request"], t["pool_frames"],
                                   t["kept_requests"] - 1)
        self.spans, done_at, futures, kept = [], [], {}, {}
        batches0 = engine.device_batches

        def submit():
            i, o, k, dropped = requests.next()
            kept.pop(dropped, None)
            self.spans.append((o, k))
            done_at.append(math.nan)
            f = engine.submit(*self.inputs_of(i))
            f.add_done_callback(lambda _, i=i: done_at.__setitem__(i, time.perf_counter()))
            futures[f] = i
            return f

        def collect(finished):
            for f in finished:
                if f.exception() is None and futures[f] in requests.held():
                    kept[futures[f]] = f.result()

        self.t_window = t0 = time.perf_counter()
        close = t0 + seconds
        trace_at = close - TRACE_SECONDS if tracer else math.inf
        pending = {submit() for _ in range(t["clients"])}
        while (now := time.perf_counter()) < close:
            if now >= trace_at and not tracer.on:
                tracer.start()
            until = trace_at if tracer and not tracer.on else close
            finished, pending = concurrent.futures.wait(
                pending, timeout=max(0.0, until - now),
                return_when=concurrent.futures.FIRST_COMPLETED)
            collect(finished)
            pending |= {submit() for _ in finished}
        if tracer:
            tracer.close()
        out_at_close = len(pending)
        finished, pending = concurrent.futures.wait(pending, timeout=CLOSE_WAIT_SECONDS)
        collect(finished)
        window_s = time.perf_counter() - t0
        if not pending:
            engine.stop()
        tracer_out = tracer.stop() if tracer else None
        ok = [f.done() and f.exception() is None and not math.isnan(done_at[i])
              for f, i in futures.items()]
        sizes = [k for _, k in self.spans]
        self.kept = {i: v for i, v in kept.items() if i in requests.held()}
        rec = self.record(window_s, len(sizes), ok.count(False),
                          sum(k for k, good in zip(sizes, ok) if good), batches0, tracer_out,
                          close)
        rec.frames_in_window = sum(k for k, d in zip(sizes, done_at) if d <= close)
        rec.seconds = seconds
        rec.notes.append(f"{len(sizes)} requests from {t['clients']} clients; {out_at_close} "
                         f"out at the close, back {window_s - seconds:.3f} s after it")
        return rec


LOOPS = {"score": ScoreLoop, "stream": StreamLoop}
