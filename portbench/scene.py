"""The benchmark's inputs, made from ``--seed`` on the device: the network
weights, the NeRF-synthetic-shaped ray store of a procedural scene, and
the camera poses.  The program under test and the plain reference are
handed the same tensors; neither makes its own.

Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np
import torch

DIR_DIM = 27  # 3 + 2 * 3 * 4 view-direction PE features
IPE_DIM = 96  # 2 * 3 * 16 IPE features
DIR_HIDDEN = 128
TRUNK_LAYERS, SKIP = 8, 5


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) of the run's ``seed``: the
    weights, the store and the step's draws get unrelated streams."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def leaf_shapes(hidden: int, depth_head: bool) -> List[Tuple[str, tuple]]:
    """``(name, shape)`` of a MipMLP / DepthMipMLP's parameters in the
    order of the network's ``named_parameters``."""
    out = []
    for i in range(TRUNK_LAYERS):
        fan_in = IPE_DIM if i == 0 else hidden + (IPE_DIM if i == SKIP else 0)
        out += [(f"layers_xyz.{i}.weight", (hidden, fan_in)),
                (f"layers_xyz.{i}.bias", (hidden,))]
    out += [("fc_feat.weight", (hidden, hidden)), ("fc_feat.bias", (hidden,)),
            ("fc_alpha.weight", (1, hidden)), ("fc_alpha.bias", (1,)),
            ("layers_dir.0.weight", (DIR_HIDDEN, hidden + DIR_DIM)),
            ("layers_dir.0.bias", (DIR_HIDDEN,)),
            ("fc_rgb.weight", (3, DIR_HIDDEN)), ("fc_rgb.bias", (3,))]
    if depth_head:
        out += [("fc_mu_sigma.weight", (2, DIR_HIDDEN)),
                ("fc_mu_sigma.bias", (2,))]
    return out


def net_specs(cfg: dict) -> List[Tuple[str, int, bool]]:
    """``(name, hidden, depth_head)`` of each network of a config dict,
    coarse first: DDNeRF's two, mip-NeRF's one shared."""
    nerf = cfg["nerf"]
    if nerf["type"] == "DDNerfModel":
        return [("coarse", nerf["coarse_hidden_size"], True),
                ("fine", nerf["fine_hidden_size"], False)]
    return [("coarse", nerf["coarse_hidden_size"], False)]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every network's float32 parameters, torch ``nn.Linear``'s init
    (uniform in +-1/sqrt(fan_in) for weight and bias), from one uniform
    draw per network on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    nets = {}
    for name, hidden, depth_head in net_specs(cfg):
        shapes = leaf_shapes(hidden, depth_head)
        total = sum(math.prod(s) for _, s in shapes)
        draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
        fan_in = {leaf.rsplit(".", 1)[0]: shape[1] for leaf, shape in shapes
                  if leaf.endswith(".weight")}
        leaves, at = {}, 0
        for leaf, shape in shapes:
            n = math.prod(shape)
            bound = 1.0 / math.sqrt(fan_in[leaf.rsplit(".", 1)[0]])
            leaves[leaf] = draw[at:at + n].view(shape) * bound
            at += n
        nets[name] = leaves
    return nets


# ------------------------------------------------------------------ poses


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """Blender-convention camera-to-world [4, 4] float32 (the NeRF
    loaders' ``pose_spherical``)."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(ph), -math.sin(ph), 0],
                        [0, math.sin(ph), math.cos(ph), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]])
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    return (flip @ rot_theta @ rot_phi @ trans).astype(np.float32)


def orbit_poses(frames: int, elevation_deg: float, radius: float) -> np.ndarray:
    """``frames`` poses evenly round the object: the video path."""
    angles = np.linspace(-180.0, 180.0, frames + 1)[:-1]
    return np.stack([pose_spherical(a, elevation_deg, radius) for a in angles])


def focal_of(scene: dict) -> float:
    return 0.5 * scene["width"] / math.tan(0.5 * scene["camera_angle_x"])


# ------------------------------------------------------------------ store


def _camera_dirs(h: int, w: int, focal: float, device) -> torch.Tensor:
    jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([(ii - w * 0.5) / focal, -(jj - h * 0.5) / focal,
                        -torch.ones_like(ii)], dim=-1).reshape(-1, 3)


def _shade(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The procedural scene's colour along each ray: a textured sphere of
    radius 1.2 at the origin on black (the blender images' background
    without ``white_background``)."""
    d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    b = torch.sum(origins * d, dim=-1)
    c = torch.sum(origins * origins, dim=-1) - 1.2 ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    p = origins + t[:, None] * d
    rgb = 0.5 + 0.5 * torch.sin(3.0 * p + torch.tensor([0.0, 2.0, 4.0],
                                                       device=p.device))
    return torch.where(hit[:, None], rgb, torch.zeros_like(rgb))


def make_store(scene: dict, seed: int, device) -> torch.Tensor:
    """The training ray store ``[views, H * W, 10]`` (origin, direction,
    radius, rgb per pixel, float32) of ``scene``'s train views, made on
    ``device``: poses drawn from the seed, then one view's rays at a
    time written into the store."""
    rng = np.random.default_rng(sub_seed(seed, "store"))
    n, h, w = scene["views"], scene["height"], scene["width"]
    lo, hi = scene["elevation_deg"]
    poses = [pose_spherical(rng.uniform(-180.0, 180.0), -rng.uniform(lo, hi),
                            scene["radius"]) for _ in range(n)]
    focal = focal_of(scene)
    cam = _camera_dirs(h, w, focal, device)
    radius = 2.0 / math.sqrt(12.0) / focal
    store = torch.empty((n, h * w, 10), dtype=torch.float32, device=device)
    for v, pose in enumerate(poses):
        c2w = torch.from_numpy(pose).to(device)
        dirs = cam @ c2w[:3, :3].T
        origins = c2w[:3, 3].expand_as(dirs)
        store[v, :, 0:3] = origins
        store[v, :, 3:6] = dirs
        store[v, :, 6] = radius
        store[v, :, 7:10] = _shade(origins, dirs)
    return store
