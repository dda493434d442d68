"""The comparison that decides ``correct``: the numbers read from the
program's output and the plain reference's on the same inputs.

Training (per leaf, taken by the worst leaf): the gap between the
program's and the reference's norm of a quantity, over the larger of the
reference's norm of that leaf and of the median leaf.  A leaf whose
reference gradient is under a thousandth of the median leaf's moves under
Adam by round-off alone, and is left out of the parameters' change.
Frames: the root mean square difference of the uint8 maps, in levels.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np
import torch

Readings = Dict[str, object]
ADAM_B1 = 0.9


def norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in leaves.items()}


def train_readings(losses: List[float], grad_first: Dict[str, torch.Tensor],
                   grad_replayed: Dict[str, torch.Tensor],
                   params_last: Dict[str, torch.Tensor],
                   params_first: Dict[str, torch.Tensor]) -> Readings:
    """What a training run is judged by: each step's loss, the norms of
    the first step's gradient and of the first replayed step's, and the
    norm of each leaf's change over the steps."""
    return {"losses": list(losses), "grad_first": norms(grad_first),
            "grad_replayed": norms(grad_replayed),
            "change": norms({k: params_last[k] - params_first[k]
                             for k in params_first})}


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None):
    names = [k for k in ref if keep is None or k in keep]
    floor = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in names}


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    return max(_leaf_gaps(prog, ref, keep).values())


def train_worst(prog: Readings, ref: Readings) -> Dict[str, str]:
    """Where each training number's worst reading is: the step or the
    leaf (a diagnostic for ``calibrate.py``)."""
    out = {}
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    out["loss_gap"] = f"step {1 + gaps.index(max(gaps))}"
    for key in ("grad_first", "grad_replayed", "change"):
        g = _leaf_gaps(prog[key], ref[key])
        leaf = max(g, key=g.get)
        out[key] = f"{leaf} {g[leaf]:.3g} (norm {ref[key][leaf]:.3g})"
    return out


def train_numbers(prog: Readings, ref: Readings) -> Dict[str, float]:
    """``loss_gap``: the worst step's |loss - reference| / reference;
    ``grad_gap``: the worst leaf's norm gap of the two gradients read;
    ``change_gap``: the worst leaf's norm gap of the parameters' change,
    over the leaves the reference's first gradient moves."""
    lp, lr = prog["losses"], ref["losses"]
    if len(lp) != len(lr):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "change_gap": math.inf}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lp, lr))
    grad_gap = max(_leaf_gap(prog[k], ref[k]) for k in ("grad_first", "grad_replayed"))
    g = ref["grad_first"]
    floor = 1e-3 * statistics.median(g.values())
    keep = {k for k, v in g.items() if v >= floor}
    return {"loss_gap": _nan_is_inf(loss_gap), "grad_gap": _nan_is_inf(grad_gap),
            "change_gap": _nan_is_inf(_leaf_gap(prog["change"], ref["change"], keep))}


def frame_numbers(prog: List[tuple], ref: List[tuple]) -> Dict[str, float]:
    """``rgb_rmse`` / ``disp_rmse``: the worst frame's root mean square
    difference of the uint8 rgb / disparity maps, in levels."""
    def rmse(a, b):
        d = a.astype(np.float64) - b.astype(np.float64)
        return float(np.sqrt(np.mean(d * d)))

    return {"rgb_rmse": max(rmse(p[0], r[0]) for p, r in zip(prog, ref)),
            "disp_rmse": max(rmse(p[1], r[1]) for p, r in zip(prog, ref))}


def _nan_is_inf(x: float) -> float:
    return math.inf if not math.isfinite(x) else x
