"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).
Each takes a :class:`~portbench.harness.LayerRun` and returns None where
the run holds nothing to read: another kind of cell, or no trace."""

from __future__ import annotations

from typing import Optional

from portbench.counts import PEAK_BF16_FLOPS


def _traced(run, kind: str):
    if run.kind != kind or run.trace is None or run.traced_items <= 0:
        return None
    return run.trace


def idle_share(run, kind: str) -> Optional[float]:
    """The device's idle share of the traced stretch, in %: one minus the
    union of its activity intervals over the stretch's wall, both from the
    trace.  The union is clipped to the stretch, so the share lies in
    [0, 100]; the stretch carries the profiler's own cost."""
    t = _traced(run, kind)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mlp_roofline(run, kind: str) -> Optional[float]:
    t = _traced(run, kind)
    if t is None or t.mlp_s <= 0:
        return None
    return 100.0 * run.bound_ms_per_item * 1e-3 * run.traced_items / t.mlp_s


def other_device_ms(run, kind: str) -> Optional[float]:
    t = _traced(run, kind)
    if t is None or t.mlp_s <= 0:
        return None
    return 1e3 * t.other_s / run.traced_items


def mfu(run, kind: str) -> Optional[float]:
    if run.kind != kind or run.items <= 0 or run.window_s <= 0:
        return None
    return 100.0 * run.flop_per_item * run.items / run.window_s / PEAK_BF16_FLOPS
