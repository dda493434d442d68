"""Weights: JAX parameter trees -> the port's state dicts, and the
reference ``checkpoint.ckpt`` format.

The port's modules carry the torch reference's parameter names
(``layers_xyz.{i}``, ``fc_feat``, ``fc_alpha``, ``layers_dir.0``,
``fc_rgb``, ``fc_mu_sigma``; reference train_model.py:248-263), so a
reference checkpoint loads with ``load_state_dict`` directly.  The JAX
package names the same layers ``trunk_{i}`` / ``dir_0`` and stores kernels
transposed (``ddnerf_tpu/train/torch_compat.py``).

Every conversion COPIES: a state dict that aliased the numpy arrays it came
from would change when the source is mutated, which once voided a whole
set of parity tests.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

_HEADS = ("fc_feat", "fc_alpha", "fc_rgb", "fc_mu_sigma")


def _torch_name(jax_name: str) -> str:
    if jax_name.startswith("trunk_"):
        return f"layers_xyz.{jax_name[len('trunk_'):]}"
    if jax_name.startswith("dir_"):
        return f"layers_dir.{jax_name[len('dir_'):]}"
    if jax_name in _HEADS:
        return jax_name
    raise KeyError(f"unrecognized JAX parameter group {jax_name!r}")


def params_to_state_dict(params: Mapping[str, Mapping[str, Any]]
                         ) -> Dict[str, torch.Tensor]:
    """One network's JAX parameter tree (numpy-convertible leaves) -> a
    state dict of fresh f32 tensors: ``kernel [in, out]`` becomes
    ``weight [out, in]``."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaves in params.items():
        prefix = _torch_name(name)
        kernel = np.array(leaves["kernel"], dtype=np.float32, copy=True)
        bias = np.array(leaves["bias"], dtype=np.float32, copy=True)
        sd[f"{prefix}.weight"] = torch.tensor(np.ascontiguousarray(kernel.T))
        sd[f"{prefix}.bias"] = torch.tensor(bias)
    return sd


def _host(tree):
    """A copy of a state dict (nested dicts / lists of tensors) on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, coarse: torch.nn.Module,
                    fine: torch.nn.Module | None, step: int = 0,
                    extra: Mapping[str, Any] | None = None) -> None:
    """Write a reference-format ``checkpoint.ckpt`` (train_model.py:248-263):
    ``model_1_state_dict`` = coarse net, ``model_2_state_dict`` = fine net,
    ``iter`` = step, plus the entries of ``extra`` (e.g. an optimizer's
    state dict).  Tensors are saved from host copies; the file is written
    under a temporary name and renamed, so a reader never sees half of it."""
    ckpt = {"iter": int(step), "model_1_state_dict": _host(coarse.state_dict())}
    if fine is not None:
        ckpt["model_2_state_dict"] = _host(fine.state_dict())
    ckpt.update(_host(dict(extra or {})))
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference-format ``checkpoint.ckpt`` onto the host:
    ``{"coarse": state_dict, "fine": state_dict | None, "step": int}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {
        "coarse": ckpt["model_1_state_dict"],
        "fine": ckpt.get("model_2_state_dict"),
        "step": int(ckpt.get("iter", 0)),
    }
