"""Profiling / tracing.  Counterpart of ``ddnerf_tpu/utils/profiling.py``.

* :func:`trace`: a ``torch.profiler`` scope over the host and, where there
  is one, the CUDA device, that writes a Chrome trace under
  ``logdir/plugins/profile/`` (the directory the JAX package's trace uses);
* :func:`summarize`: the digest of such a profile: ms per step, device
  busy time and device activities per step, the largest kernels;
* :func:`annotate`: a named span inside a profile;
* :class:`Throughput`: rays/sec counter with warm-up exclusion.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str, enable: bool = True):
    """Profile the scope -> the ``torch.profiler.profile`` object (None
    when not ``enable``); on exit the Chrome trace is written to
    ``logdir/plugins/profile/<time>/trace.json``, its path kept in the
    object's ``trace_path``."""
    if not enable:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    out = os.path.join(logdir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(out, exist_ok=True)
    prof.trace_path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(prof.trace_path)


def annotate(name: str):
    return torch.profiler.record_function(name)


def summarize(prof, steps: int, top: int = 12, tag: str = "profile") -> str:
    """The digest of a profile of ``steps`` steps: the profiled window per
    step on the host's clock, then per step the device busy time (the sum
    of the device activities' times), the device span (first activity's
    start to the last one's end), the number of device activities (kernels,
    copies and memsets: under a CUDA-graph replay, the graph's nodes) and
    the ``top`` largest by total time.  A profile without device activity
    (a CPU run) says so."""
    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    if not events:
        return f"[{tag}] the profile holds no events"
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    lines = [f"[{tag}] {steps} steps in a {window:.2f} ms window: "
             f"{window / steps:.2f} ms/step under the profiler"]
    # Device activities only: a profiler annotation of the host side (the
    # optimizer's step) also shows on the device track, as a span over the
    # kernels it holds, and would count them twice.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        lines.append(f"[{tag}] no device activity in the profile (a CPU run)")
        return "\n".join(lines)
    busy = sum(e.device_time for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    lines.append(
        f"[{tag}] per step: device busy {busy / steps:.2f} ms of a "
        f"{span / steps:.2f} ms span ({100 * busy / span:.1f}% busy), "
        f"{len(kernels) / steps:.0f} device activities")
    totals = {}
    for e in kernels:
        t = totals.setdefault(e.name, [0.0, 0])
        t[0] += e.device_time / 1e3
        t[1] += 1
    for name, (total, count) in sorted(totals.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"[{tag}]   {total / steps:7.3f} ms  "
                     f"{count / steps:6.1f} launches  {name[:100]}")
    return "\n".join(lines)


class Throughput:
    """Steady-state rays/sec counter with warmup exclusion."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self._count = 0
        self._rays = 0
        self._t0 = None

    def step(self, num_rays: int) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._rays = 0
        elif self._count > self.warmup_steps:
            self._rays += num_rays

    @property
    def rays_per_sec(self) -> float:
        if self._t0 is None or self._rays == 0:
            return 0.0
        return self._rays / (time.perf_counter() - self._t0)
