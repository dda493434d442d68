"""MipMLP and DepthMipMLP as ``nn.Module`` s — the plain PyTorch version of
the MLP that the fused kernel (:mod:`ddnerf_tpu_torch.kernels.fused_mlp`)
is held against.

Counterpart of ``ddnerf_tpu/models/mlp.py`` (reference
base_architectures.py:3-126): an 8-layer trunk whose layer 5 takes the
concat ``[ipe, x]``, a density head off ``fc_feat``, one 128-wide
view-direction layer feeding the rgb head and, for ``DepthMipMLP``, the
``fc_mu_sigma`` head.  Parameter names are the torch reference's, so a
reference ``checkpoint.ckpt`` loads with ``load_state_dict``.

Numerics follow the JAX package at its compute dtype: every matmul operand
is rounded to ``compute_dtype`` and the product is taken in float32
(``a.to(cdt).float() @ w.to(cdt).float()``), which is bf16 × bf16 with f32
accumulation — a bf16 ``torch.matmul`` would round its OUTPUT to bf16
instead.  Biases, activations and outputs stay float32.  On a GPU the
float32 matmul must not use TF32; the pipeline and ``chip_smoke.py`` turn
``torch.backends.cuda.matmul.allow_tf32`` off.

The view directions are projected once per ray and broadcast over the
sample axis (``_mlp_heads``, mlp.py:233-288).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

IPE_DIM = 96  # 2 * 3 * 16 IPE features
DIR_DIM = 27  # 3 + 2 * 3 * 4 view-direction PE features


def _linear(fan_in: int, fan_out: int) -> nn.Linear:
    # Uninitialized: weights come from init_weights' explicit generator.
    return nn.utils.skip_init(nn.Linear, fan_in, fan_out)


class _MipMLPBase(nn.Module):
    depth_head = False

    def __init__(
        self,
        hidden_size: int = 256,
        num_trunk_layers: int = 8,
        skip_layer: int = 5,
        dir_hidden: int = 128,
        compute_dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_trunk_layers = num_trunk_layers
        self.skip_layer = skip_layer
        self.dir_hidden = dir_hidden
        self.compute_dtype = compute_dtype
        self.layers_xyz = nn.ModuleList(
            _linear(IPE_DIM + hidden_size if i == skip_layer
                    else (IPE_DIM if i == 0 else hidden_size), hidden_size)
            for i in range(num_trunk_layers)
        )
        self.fc_feat = _linear(hidden_size, hidden_size)
        self.fc_alpha = _linear(hidden_size, 1)
        self.layers_dir = nn.ModuleList([_linear(hidden_size + DIR_DIM,
                                                 dir_hidden)])
        self.fc_rgb = _linear(dir_hidden, 3)
        if self.depth_head:
            self.fc_mu_sigma = _linear(dir_hidden, 2)
        self.init_weights(generator)

    @property
    def out_dim(self) -> int:
        return 6 if self.depth_head else 4

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None):
        """torch's ``nn.Linear`` default init — weight and bias uniform in
        ±1/sqrt(fan_in) (kaiming_uniform with a=sqrt(5)) — drawn from
        ``generator`` in parameter order, on the host."""
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                bound = 1.0 / math.sqrt(layer.in_features)
                for p in (layer.weight, layer.bias):
                    draw = torch.empty(p.shape, dtype=torch.float32)
                    draw.uniform_(-bound, bound, generator=generator)
                    p.copy_(draw)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        """Round a matmul operand to the compute dtype, keep it float32."""
        return x.to(self.compute_dtype).float()

    def _dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        return self._q(x) @ self._q(layer.weight).T + layer.bias

    def forward(self, ipe: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """``ipe [..., S, 96]`` and per-ray ``dirs [..., 27]`` ->
        ``[..., S, 4|6]`` float32 = (rgb, alpha[, raw_mu, raw_sigma])."""
        x = ipe
        for i, layer in enumerate(self.layers_xyz):
            inp = torch.cat([ipe, x], dim=-1) if i == self.skip_layer else x
            x = torch.relu(self._dense(inp, layer))
        feat = self._q(self._dense(x, self.fc_feat))
        alpha = feat @ self._q(self.fc_alpha.weight).T + self.fc_alpha.bias
        wd = self.layers_dir[0].weight  # [dir_hidden, hidden + 27]
        h_dim = self.hidden_size
        dproj = self._q(dirs) @ self._q(wd[:, h_dim:]).T  # once per ray
        h = torch.relu(feat @ self._q(wd[:, :h_dim]).T + dproj[..., None, :]
                       + self.layers_dir[0].bias)
        outs = [self._dense(h, self.fc_rgb), alpha]
        if self.depth_head:
            outs.append(self._dense(h, self.fc_mu_sigma))
        return torch.cat(outs, dim=-1)


class MipMLP(_MipMLPBase):
    """mip-NeRF MLP; output ``[..., 4]`` = (rgb 3, alpha 1)."""

    depth_head = False


class DepthMipMLP(_MipMLPBase):
    """DDNeRF coarse MLP with the (μ, σ) head; output ``[..., 6]`` =
    (rgb 3, alpha 1, raw_mu 1, raw_sigma 1)."""

    depth_head = True
