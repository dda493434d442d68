"""Reading a ``torch.profiler`` trace of a steady stretch: the device's
busy time as the union of its activity intervals (overlapping activities
count once), the idle gaps between them labelled by what the host was
doing, the operations that took most device time, and the share of that
time in the program's MLP kernels, picked out by name.

The stretch is the span the benchmark opens with
``torch.profiler.record_function(STRETCH)``; the benchmark's own spans
around its calls into the program are named ``portbench.*``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

STRETCH = "portbench.stretch"
SPAN_PREFIX = "portbench."

# The program's fused-MLP kernels (kernels/csrc/*.cu, each in an anonymous
# namespace), by function name: the forward, the backward's chain, weight
# gradient and reduction passes, the float32 and wide plans.
MLP_KERNEL = re.compile(
    r"(?:^|[\s*&])(?:\(anonymous namespace\)::)?"
    r"(?:fused_mlp_fwd|dir_proj|chain|wgrad|dproj_grad|dirs_grad_partial|"
    r"dirs_grad_reduce|reduce|bias_reduce|tf32_split|float_\w+|wide_\w+)"
    r"_kernel\b")


def is_mlp_kernel(name: str) -> bool:
    """Whether a device activity's name is one of the MLP kernels.  Torch's
    own ``at::native::reduce_kernel`` is not: only a bare or
    anonymous-namespace name counts."""
    return MLP_KERNEL.search(name) is not None


@dataclass(frozen=True)
class Interval:
    name: str
    start: float  # seconds, the trace's clock
    end: float


@dataclass
class Digest:
    """What a stretch's trace says, in seconds."""

    window_s: float
    busy_s: float
    mlp_s: float
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def other_s(self) -> float:
        return self.busy_s - self.mlp_s


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float,
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _innermost(host: Sequence[Interval], t: float, spans: bool) -> Optional[str]:
    best = None
    for h in host:
        if h.start <= t <= h.end and h.name.startswith(SPAN_PREFIX) == spans:
            if best is None or h.end - h.start < best.end - best.start:
                best = h
    return None if best is None else best.name


def digest(device: Sequence[Interval], host: Sequence[Interval], top: int = 10,
           ) -> Optional[Digest]:
    """The digest of the stretch span among ``host`` (None if absent):
    device activities are clipped to it.  An idle gap is labelled by the
    innermost benchmark span and host operation running at its middle."""
    stretch = [h for h in host if h.name == STRETCH]
    if not stretch:
        return None
    lo, hi = stretch[0].start, stretch[0].end
    inside = [(max(d.start, lo), min(d.end, hi), d.name) for d in device
              if d.end > lo and d.start < hi]
    busy = union_seconds([(s, e) for s, e, _ in inside])
    mlp = union_seconds([(s, e) for s, e, n in inside if is_mlp_kernel(n)])
    totals = {}
    for s, e, n in inside:
        totals[n] = totals.get(n, 0.0) + (e - s)
    top_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    longest = sorted(gaps([(s, e) for s, e, _ in inside], lo, hi),
                     key=lambda g: g[0] - g[1])[:top]
    labelled = []
    inner_host = [h for h in host if h.name != STRETCH]
    for s, e in longest:
        mid = 0.5 * (s + e)
        span = _innermost(inner_host, mid, spans=True) or STRETCH
        op = _innermost(inner_host, mid, spans=False)
        labelled.append((span + (f" / {op}" if op else ""), e - s))
    return Digest(window_s=hi - lo, busy_s=busy, mlp_s=mlp, top_ops=top_ops,
                  idle_gaps=labelled)


def from_profile(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device activities, host events) of a finished
    ``torch.profiler.profile``, in seconds.  A host-side annotation that
    also shows on the device track is left out of the device list."""
    import torch

    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if end <= start:
            continue
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(Interval(e.name, start, end))
        else:
            host.append(Interval(e.name, start, end))
    return device, host
