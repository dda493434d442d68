"""The port's tracer, its counters and its profiler scope.  Counterpart of
``ddnerf_tpu/utils/profiling.py``.

* :func:`span`: a named stretch of the program (``ddnerf.<layer>.<stage>``)
  at a layer boundary.  Off by default (:func:`enable`, :func:`disable`):
  a span is then one boolean check and a shared null context.  A live
  span records its name, an id, its parent's id and the host's
  ``perf_counter_ns`` at both ends; on a CUDA device a pair of timing
  events on the current stream, read at the first :func:`snapshot` after
  they complete (a span never synchronises); and, while a
  ``torch.profiler`` records, a ``record_function`` of the same name, so
  the span lies on the profiler's timeline too.
* CUDA graphs (:class:`GraphCensus`, opened by the captured train step
  around each capture): the finished graph's device operations (kernel,
  memcpy and memset nodes) are always counted, once, after the capture.
  With the tracer live, every span of the capture also reads the
  capturing graph's count at its two ends (the graph's nodes by stage),
  and its events become event-record nodes of the graph, so that every
  replay times each stage on the device (:func:`replaying`).  With the
  tracer off, the capture is untouched: its graph holds no event node.
* Counters: one registry of named integers, always on (a dict add):
  :func:`counters` gives a group's dict (the fused kernels' ``LAUNCHES``
  and ``CAPTURED`` are the groups ``kernels.launches`` and
  ``kernels.captured``), :func:`count` adds, :func:`counter` reads.
* :func:`snapshot`: the record (bounded; ``dropped`` counts what did not
  fit) as plain data, each span with its host and device ms and their
  ``self`` part (the duration less what its children cover), with the
  offset from the tracer's clock to the last profile's, measured from the
  spans both saw; :func:`stage_table` prints it by stage and
  :func:`setup_line` its set-up (library load, warm-up, captures, the host
  time a replayed step).
* :func:`trace`: a ``torch.profiler`` scope over the host and the CUDA
  device that writes a Chrome trace under ``logdir/plugins/profile/``
  (the directory the JAX package's trace uses), and beside it the
  tracer's spans on the profile's time axis; :func:`summarize`: its
  digest (device busy time as the union of the activities' intervals).

The tracer is one per process and its spans are opened and closed by one
thread, the one that drives the device.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import os
import statistics
import time
from typing import Dict, Iterable, List, Optional

import torch

STEP_ROOT = "ddnerf.step.iteration"
FRAME_ROOT = "ddnerf.render.frame"
LIMIT = 1 << 18  # spans the record holds; later ones are counted as dropped

_NULL = contextlib.nullcontext()
_LIVE = False


class _Record:
    __slots__ = ("name", "id", "parent", "kind", "t0", "t1", "start", "end",
                 "device_ms", "nodes", "profiled")

    def __init__(self, name: str, parent: Optional[int], kind: str):
        self.name, self.parent, self.kind = name, parent, kind
        self.id = next(_ids)
        self.t0 = self.t1 = None  # host perf_counter_ns
        self.start = self.end = None  # CUDA timing events
        self.device_ms = self.nodes = None
        self.profiled = False


_ids = itertools.count(1)
_records: List[_Record] = []
_stack: List[_Record] = []
_dropped = 0
_census: Optional["GraphCensus"] = None
_last_profile = None


def enable() -> None:
    """Turn the tracer on: spans record from here."""
    global _LIVE
    _LIVE = True


def disable() -> None:
    """Turn the tracer off, first reading the device times of what it
    recorded (this waits for their events)."""
    global _LIVE
    _read(_records, wait=True)
    _LIVE = False


def enabled() -> bool:
    return _LIVE


def reset(kinds: Optional[Iterable[str]] = None) -> None:
    """Empty the record, or drop its spans of ``kinds`` alone (eager,
    captured, replayed); the counters stay."""
    global _dropped, _last_profile
    if kinds is None:
        _records.clear()
    else:
        _records[:] = [r for r in _records if r.kind not in tuple(kinds)]
    _dropped = 0
    _last_profile = None


def span(name: str):
    """The stretch of the program that ``with span(name):`` encloses."""
    if not _LIVE:
        return _NULL
    return _Span(name)


class _Span:
    __slots__ = ("rec", "rf", "n0")

    def __init__(self, name: str):
        parent = _stack[-1].id if _stack else None
        capturing = (_census is not None
                     and torch.cuda.is_current_stream_capturing())
        self.rec = _Record(name, parent, "captured" if capturing else "eager")
        self.rf = None

    def __enter__(self):
        rec = self.rec
        _stack.append(rec)
        self.n0 = _census.nodes_now() if _census is not None else None
        rec.t0 = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(rec.name)
            self.rf.__enter__()
            rec.profiled = True
        if torch.cuda.is_initialized():
            external = rec.kind == "captured"
            rec.start = torch.cuda.Event(enable_timing=True, external=external)
            rec.end = torch.cuda.Event(enable_timing=True, external=external)
            rec.start.record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec.end is not None:
            rec.end.record()
        rec.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if _census is not None:
            n1 = _census.nodes_now()
            if self.n0 is not None and n1 is not None:
                rec.nodes = n1 - self.n0
            _census.spans.append(rec)
        _stack.pop()
        _keep(rec)
        return False


def _keep(rec: _Record) -> None:
    global _dropped
    if len(_records) < LIMIT:
        _records.append(rec)
    else:
        _dropped += 1


# ----------------------------------------------------------------- counters

_COUNTERS: Dict[str, Dict[str, int]] = {}


def counters(group: str, names: Iterable[str] = ()) -> Dict[str, int]:
    """The registry's dict of ``group``, holding each of ``names`` (0 the
    first time): a plain dict, counted into with ``d[name] += n``."""
    d = _COUNTERS.setdefault(group, {})
    for name in names:
        d.setdefault(name, 0)
    return d


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (``group.key``)."""
    group, _, key = name.rpartition(".")
    d = _COUNTERS.setdefault(group, {})
    d[key] = d.get(key, 0) + n


def set_counter(name: str, value: int) -> None:
    group, _, key = name.rpartition(".")
    _COUNTERS.setdefault(group, {})[key] = value


def counter(name: str) -> Optional[int]:
    """Counter ``name``, None where nothing set it."""
    group, _, key = name.rpartition(".")
    return _COUNTERS.get(group, {}).get(key)


def counter_values() -> Dict[str, int]:
    return {f"{g}.{k}": v for g, d in _COUNTERS.items() for k, v in d.items()}


# --------------------------------------------------------------- CUDA graphs

# CUgraphNodeType, CUstreamCaptureStatus
_DEVICE_OPS = (0, 1, 2)  # kernel, memcpy, memset
_EVENT_NODES = (6, 7)  # event wait, event record
_CAPTURE_ACTIVE = 1


class _GraphApi:
    """``cuGraphGetNodes``, ``cuGraphNodeGetType`` and
    ``cuStreamGetCaptureInfo_v2`` of the CUDA driver (``libcuda.so.1``),
    which take the runtime's graphs and streams as they are and leave its
    error state alone.  A call that fails raises ``OSError``."""

    def __init__(self, lib: ctypes.CDLL):
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        self.get_nodes = lib.cuGraphGetNodes
        self.get_nodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(sz)]
        self.node_type = lib.cuGraphNodeGetType
        self.node_type.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        self.capture_info = lib.cuStreamGetCaptureInfo_v2
        self.capture_info.argtypes = [
            vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ulonglong),
            ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(sz)]
        for f in (self.get_nodes, self.node_type, self.capture_info):
            f.restype = ctypes.c_int

    @staticmethod
    def _check(err: int, what: str) -> None:
        if err != 0:
            raise OSError(f"{what} returned CUDA error {err}")

    def nodes(self, graph: int) -> List[int]:
        n = ctypes.c_size_t(0)
        self._check(self.get_nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        if n.value == 0:
            return []
        out = (ctypes.c_void_p * n.value)()
        self._check(self.get_nodes(graph, out, ctypes.byref(n)), "cuGraphGetNodes")
        return [int(v or 0) for v in out[:n.value]]

    def kind(self, node: int) -> int:
        t = ctypes.c_int(-1)
        self._check(self.node_type(node, ctypes.byref(t)), "cuGraphNodeGetType")
        return t.value

    def capturing_graph(self, stream: int) -> Optional[int]:
        status, capture_id = ctypes.c_int(0), ctypes.c_ulonglong(0)
        graph, deps = ctypes.c_void_p(None), ctypes.c_void_p(None)
        ndeps = ctypes.c_size_t(0)
        self._check(self.capture_info(
            stream, ctypes.byref(status), ctypes.byref(capture_id),
            ctypes.byref(graph), ctypes.byref(deps), ctypes.byref(ndeps)),
            "cuStreamGetCaptureInfo")
        return graph.value if status.value == _CAPTURE_ACTIVE else None

    def census(self, graph: int):
        """(device operations, event nodes) of a graph."""
        kinds = [self.kind(n) for n in self.nodes(graph)]
        return (sum(k in _DEVICE_OPS for k in kinds),
                sum(k in _EVENT_NODES for k in kinds))


_API: List[Optional[_GraphApi]] = []


def graph_api() -> Optional[_GraphApi]:
    """The graph calls, or None without a CUDA device or a driver library
    that has them."""
    if not _API:
        api = None
        if torch.cuda.is_available():
            torch.cuda.init()
            try:
                api = _GraphApi(ctypes.CDLL("libcuda.so.1"))
            except (OSError, AttributeError):
                api = None
        _API.append(api)
    return _API[0]


class GraphCensus:
    """The device operations a CUDA-graph capture records: opened around
    the capture (``with GraphCensus() as census``); :meth:`count` then
    takes the finished graph's count, ``ops`` and ``events``.  With the
    tracer live at the capture, every span of it reads the capturing
    graph's count at its two ends (``nodes`` of the span's record):
    ``spans`` are the capture's span records in the order they closed.
    With the tracer off, the census touches no span of the capture.
    Where the graph cannot be read, ``refused`` says why and nothing
    holds a count."""

    def __init__(self):
        self.api = graph_api()
        self.refused = (None if self.api is not None
                        else "no CUDA driver library in the process")
        self.graph = None
        self.seen: set = set()
        self.ops = 0
        self.events = None
        self.spans: List[_Record] = []
        self.pending: List[_Record] = []  # the last replay's records

    def __enter__(self):
        global _census
        if _LIVE:
            _census = self
        return self

    def __exit__(self, *exc):
        global _census
        _census = None
        return False

    def nodes_now(self) -> Optional[int]:
        """Device operations the capturing graph holds so far."""
        if self.refused is not None:
            return None
        try:
            if self.graph is None:
                self.graph = self.api.capturing_graph(
                    torch.cuda.current_stream().cuda_stream)
                if self.graph is None:
                    return None
            new = [n for n in self.api.nodes(self.graph) if n not in self.seen]
            self.seen.update(new)
            self.ops += sum(self.api.kind(n) in _DEVICE_OPS for n in new)
        except OSError as e:
            self.refused = str(e)
            return None
        return self.ops

    def count(self, raw_graph: int) -> Optional[int]:
        """The finished graph's device operations (``raw_cuda_graph()``)."""
        self.ops = self.events = None
        if self.api is not None:
            try:
                self.ops, self.events = self.api.census(raw_graph)
            except OSError as e:
                self.refused = str(e)
        return self.ops

    def timed(self) -> List[_Record]:
        """The capture's spans whose events are event-record nodes."""
        return [r for r in self.spans if r.start is not None]

    def by_stage(self, root: str = STEP_ROOT) -> str:
        """``root``'s children with their nodes (each stage's children in
        brackets), then what lies outside ``root``: sums to ``ops``."""
        kids: Dict[Optional[int], List[_Record]] = {}
        for r in self.spans:
            kids.setdefault(r.parent, []).append(r)
        roots = [r for r in self.spans if r.name == root]
        if not self.spans:
            return "not split (the tracer was off at the capture)"
        if self.refused is not None or not roots or roots[0].nodes is None:
            return f"not split ({self.refused or 'no ' + root + ' span'})"

        def short(name):
            return name.split(".", 1)[-1]

        def grouped(rs):
            totals: Dict[str, int] = {}
            for r in sorted(rs, key=lambda r: r.id):
                totals[short(r.name)] = totals.get(short(r.name), 0) + r.nodes
            return totals

        parts = []
        top = roots[0]
        for name, n in grouped(kids.get(top.id, [])).items():
            inner = [k for r in kids.get(top.id, []) if short(r.name) == name
                     for k in kids.get(r.id, [])]
            sub = grouped(inner)
            if sub:
                sub["self"] = n - sum(sub.values())
                name += " [" + ", ".join(f"{k} {v}" for k, v in sub.items()) + "]"
            parts.append(f"{name} {n}")
        rest = top.nodes - sum(r.nodes for r in kids.get(top.id, []))
        parts.append(f"{short(root)} self {rest}")
        parts.append(f"outside {self.ops - top.nodes}")
        return " | ".join(parts) + f" = {self.ops}"


def replaying(census: GraphCensus) -> None:
    """Before a replay of the graph ``census`` took: with the tracer live
    and the graph holding stage events, read the previous replay's times
    (its events are about to be recorded again: this waits for them) and
    add this replay's spans to the record, parented under the open span."""
    if not _LIVE:
        return
    template = census.timed()
    if not template:
        return
    _read(census.pending, wait=True)
    ids = {r.id: _Record(r.name, None, "replayed") for r in template}
    parent = _stack[-1].id if _stack else None
    census.pending = []
    for r in template:
        copy = ids[r.id]
        copy.parent = ids[r.parent].id if r.parent in ids else parent
        copy.start, copy.end, copy.nodes = r.start, r.end, r.nodes
        census.pending.append(copy)
        _keep(copy)


def _read(records: Iterable[_Record], wait: bool) -> None:
    for r in records:
        if r.device_ms is not None or r.end is None or r.kind == "captured":
            continue
        if wait:
            r.end.synchronize()
        elif not r.end.query():
            continue
        r.device_ms = r.start.elapsed_time(r.end)
        r.start = r.end = None


# ------------------------------------------------------------------ snapshot

def clock_offset_ns(profile) -> Optional[int]:
    """Nanoseconds to add to a span's ``perf_counter_ns`` to put it on
    ``profile``'s time axis (``profile.events()``): the median over the
    spans both saw, matched by name in order of start."""
    mine: Dict[str, List[int]] = {}
    for r in sorted((r for r in _records if r.profiled and r.t0 is not None),
                    key=lambda r: r.t0):
        mine.setdefault(r.name, []).append(r.t0)
    theirs: Dict[str, List[float]] = {}
    for e in profile.events():
        if e.name in mine and e.device_type == torch.autograd.DeviceType.CPU:
            theirs.setdefault(e.name, []).append(e.time_range.start)
    deltas = []
    for name, t0s in mine.items():
        starts = sorted(theirs.get(name, []))
        if len(starts) == len(t0s):
            deltas += [round(s * 1e3) - t for s, t in zip(starts, t0s)]
    return int(statistics.median(deltas)) if deltas else None


def snapshot(profile=None) -> dict:
    """The record as plain data: ``spans`` (each with ``name``, ``id``,
    ``parent``, ``kind`` — eager, captured or replayed —, ``start_ns``,
    ``host_ms``, ``device_ms``, ``nodes`` and the ``host_self_ms`` /
    ``device_self_ms`` its children leave), ``counters``, ``dropped``,
    and ``clock_offset_ns`` to ``profile``'s axis (default: the last
    :func:`trace`'s), None without one."""
    _read(_records, wait=False)
    profile = profile if profile is not None else _last_profile
    offset = clock_offset_ns(profile) if profile is not None else None
    spans = []
    for r in _records:
        host = None if r.t1 is None else (r.t1 - r.t0) / 1e6
        spans.append({"name": r.name, "id": r.id, "parent": r.parent,
                      "kind": r.kind, "start_ns": r.t0, "host_ms": host,
                      "device_ms": r.device_ms, "nodes": r.nodes})
    by_id = {s["id"]: s for s in spans}
    covered: Dict[int, List[Optional[float]]] = {}
    for s in spans:
        if s["parent"] in by_id:
            c = covered.setdefault(s["parent"], [0.0, 0.0])
            for i, key in enumerate(("host_ms", "device_ms")):
                c[i] = None if c[i] is None or s[key] is None else c[i] + s[key]
    for s in spans:
        c = covered.get(s["id"], [0.0, 0.0])
        for i, key in enumerate(("host_ms", "device_ms")):
            s[key.replace("_ms", "_self_ms")] = (
                None if s[key] is None or c[i] is None else s[key] - c[i])
        if offset is not None and s["start_ns"] is not None:
            s["profile_start_us"] = (s["start_ns"] + offset) / 1e3
    return {"spans": spans, "counters": counter_values(), "dropped": _dropped,
            "clock_offset_ns": offset}


def stage_table(snap: dict, root: str, tag: str = "stages") -> str:
    """Per ``root`` span, each stage under it by path: calls, graph nodes
    (of the captured roots, else the replayed ones), device ms (of the replayed roots, else the
    eager ones), its self part, and host ms (of the eager roots, else the
    captured ones).  Empty where the snapshot holds no ``root``."""
    spans = snap["spans"]
    kids: Dict[int, List[dict]] = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    roots = {k: [s for s in spans if s["name"] == root and s["kind"] == k]
             for k in ("eager", "captured", "replayed")}
    if not any(roots.values()):
        return ""
    rows: Dict[tuple, Dict[str, list]] = {}
    cols = ("calls", "nodes", "device_ms", "device_self_ms", "host_ms")

    def walk(s, path, kind):
        acc = rows.setdefault(path, {}).setdefault(kind, [None] * len(cols))
        for i, key in enumerate(cols):
            v = 1 if key == "calls" else s[key]
            if v is not None:
                acc[i] = v if acc[i] is None else acc[i] + v
        for k in kids.get(s["id"], []):
            walk(k, path + (k["name"],), kind)

    for kind, rs in roots.items():
        for s in rs:
            walk(s, (root,), kind)
    dev = "replayed" if roots["replayed"] else "eager"
    host = "eager" if roots["eager"] else "captured"
    graph = "captured" if roots["captured"] else "replayed"
    # Beside replayed steps, the eager roots are the warm-up steps before
    # the capture, the first of which loads the kernel library: their host
    # ms are not a replayed step's (setup_line has that).
    warmup = dev == "replayed" and host == "eager"
    lines = [f"[{tag}] {root}, per root: device ms of {len(roots[dev])} {dev}, "
             f"host ms of {len(roots[host])} {host}"
             f"{' warm-up' if warmup else ''}, nodes of "
             f"{len(roots[graph])} {graph}",
             f"[{tag}] {'calls':>6} {'nodes':>6} {'device ms':>10} "
             f"{'self ms':>9} {'warmup ms' if warmup else 'host ms':>9}  stage"]

    def fmt(v, spec):
        return format(v, spec) if v is not None else "-".rjust(int(spec.split(".")[0]))

    for path, acc in rows.items():
        def per(kind, col):
            v = acc.get(kind, [None] * len(cols))[cols.index(col)]
            return None if v is None else v / len(roots[kind])

        calls = per(dev, "calls") or per(host, "calls") or per("captured", "calls")
        lines.append(
            f"[{tag}] {fmt(calls, '6.1f')} {fmt(per(graph, 'nodes'), '6.0f')} "
            f"{fmt(per(dev, 'device_ms'), '10.4f')} "
            f"{fmt(per(dev, 'device_self_ms'), '9.4f')} "
            f"{fmt(per(host, 'host_ms'), '9.3f')}  "
            f"{'  ' * (len(path) - 1)}{path[-1].split('.', 1)[-1]}")
    return "\n".join(lines)


SETUP_SPANS = ("ddnerf.kernels.load_library", "ddnerf.step.eager",
               "ddnerf.step.capture")


def setup_line(snap: dict, tag: str = "setup") -> str:
    """The set-up in the snapshot, on one line: the kernel library's load,
    the eager warm-up steps and the graph captures (calls and mean host
    ms), the counters ``kernels.library_builds`` and ``graph.captures``,
    then the host ms a replayed step: the ``ddnerf.step.replay`` spans
    that hold replayed steps, over the number of those steps."""
    spans = snap["spans"]
    parts = []
    for name in SETUP_SPANS:
        ms = [s["host_ms"] for s in spans
              if s["name"] == name and s["host_ms"] is not None]
        if ms:
            parts.append(f"{name.split('.', 1)[-1]} {len(ms)} x "
                         f"{statistics.mean(ms):.1f} host ms")
    counts = snap["counters"]
    parts.append(f"library builds {counts.get('kernels.library_builds', 0)}, "
                 f"graph captures {counts.get('graph.captures', 0)}")
    steps: Dict[int, int] = {}
    for s in spans:
        if s["kind"] == "replayed" and s["name"] == STEP_ROOT:
            steps[s["parent"]] = steps.get(s["parent"], 0) + 1
    runs = [s for s in spans if s["name"] == "ddnerf.step.replay"
            and s["id"] in steps and s["host_ms"] is not None]
    if runs:
        n = sum(steps[s["id"]] for s in runs)
        parts.append(f"replay {sum(s['host_ms'] for s in runs) / n:.4f} "
                     f"host ms a step over {n}")
    return f"[{tag}] " + "; ".join(parts)


# ------------------------------------------------------------------ profiler

@contextlib.contextmanager
def trace(logdir: str, enable: bool = True):
    """Profile the scope -> the ``torch.profiler.profile`` object (None
    when not ``enable``); on exit the Chrome trace is written to
    ``logdir/plugins/profile/<time>/trace.json``, its path kept in the
    object's ``trace_path``.  With the tracer live, its record is emptied
    on entry, and on exit the spans of the scope are written on the
    profile's time axis to ``spans.json`` beside it."""
    global _last_profile
    if not enable:
        yield None
        return
    if _LIVE:
        reset()
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
    if _records:
        _last_profile = prof
        with open(os.path.join(out, "spans.json"), "w") as f:
            json.dump(snapshot(prof), f)


def _union(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(prof, steps: int, top: int = 12, tag: str = "profile",
              unit: str = "step") -> str:
    """The digest of a profile of ``steps`` steps (or frames: ``unit``): the
    profiled window per step on the host's clock, then per step the device
    busy time (the
    union of the device activities' intervals: overlapping activities
    count once), the device span (first activity's start to the last one's
    end), the number of device activities (kernels, copies and memsets:
    under a CUDA-graph replay, the graph's nodes) and the ``top`` largest
    by total time; then, where the tracer holds spans, their stage table.
    A profile without device activity (a CPU run) says so."""
    events = [e for e in prof.events() if e.time_range.end > e.time_range.start]
    if not events:
        return f"[{tag}] the profile holds no events"
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events)) / 1e3
    lines = [f"[{tag}] {steps} {unit}s in a {window:.2f} ms window: "
             f"{window / steps:.2f} ms/{unit} under the profiler"]
    # Device activities only: a profiler annotation of the host side (the
    # optimizer's step) also shows on the device track, as a span over the
    # kernels it holds, and would count them twice.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        lines.append(f"[{tag}] no device activity in the profile (a CPU run)")
    else:
        busy = _union((e.time_range.start, e.time_range.end) for e in kernels) / 1e3
        span_ms = (max(e.time_range.end for e in kernels)
                   - min(e.time_range.start for e in kernels)) / 1e3
        lines.append(
            f"[{tag}] per {unit}: device busy {busy / steps:.2f} ms of a "
            f"{span_ms / steps:.2f} ms span ({100 * busy / span_ms:.1f}% busy), "
            f"{len(kernels) / steps:.0f} device activities")
        totals = {}
        for e in kernels:
            t = totals.setdefault(e.name, [0.0, 0])
            t[0] += e.device_time / 1e3
            t[1] += 1
        for name, (total, n) in sorted(totals.items(),
                                       key=lambda kv: -kv[1][0])[:top]:
            lines.append(f"[{tag}]   {total / steps:7.3f} ms  "
                         f"{n / steps:6.1f} launches  {name[:100]}")
    if _records:
        snap = snapshot(prof)
        for root in (STEP_ROOT, FRAME_ROOT):
            table = stage_table(snap, root, tag=f"{tag} stages")
            if table:
                lines.append(table)
    return "\n".join(lines)
