"""Numerical-safety tooling.  Counterpart of ``ddnerf_tpu/utils/debug.py``.

* :func:`nan_debug_mode`: the scope of ``--debug-nans``.  Autograd's anomaly
  detection is on inside it, so a backward function that produces a NaN
  raises with the traceback of the forward call that made it, and the train
  loop runs its eager step with the per-step finite check (``train/step.py::
  train_step(check_finite=True)``, the role of ``checkify_step``): anomaly
  detection cannot see inside a CUDA-graph replay, which runs no Python.
* :func:`assert_finite_tree`: finiteness of every tensor of a nested dict
  (a ``state_dict``, a dict of gradients), naming the first leaf that fails.
"""

from __future__ import annotations

import contextlib

import torch

_ENABLED = False


def nan_debug_enabled() -> bool:
    """Inside a :func:`nan_debug_mode` scope?"""
    return _ENABLED


@contextlib.contextmanager
def nan_debug_mode(enable: bool = True):
    """Enable autograd anomaly detection and the loop's per-step finite
    check within the scope (slower: every step is read on the host)."""
    global _ENABLED
    if not enable:
        yield
        return
    prev = _ENABLED
    _ENABLED = True
    try:
        with torch.autograd.set_detect_anomaly(True):
            yield
    finally:
        _ENABLED = prev


def assert_finite_tree(tree, name: str = "tree") -> None:
    """``AssertionError("non-finite values in {name}:{keys}")`` for the
    first leaf of ``tree`` (nested dicts of tensors, arrays or numbers)
    that holds a NaN or an infinity; ``keys`` joins the path with "/"."""

    def walk(node, path):
        if isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + (str(key),))
        elif node is not None and not bool(
                torch.isfinite(torch.as_tensor(node)).all()):
            raise AssertionError(
                f"non-finite values in {name}:{'/'.join(path)}")

    walk(tree, ())
