"""Plain PyTorch reference of the two model families the benchmark runs:
DDNeRF (Dadon et al., coarse DepthMipMLP, truncated-Gaussian resampler,
depth-prediction loss) and mip-NeRF (Barron et al., ICCV 2021: one shared
MipMLP in both cycles, inverse-CDF resampler), as their published code
computes a training step and a rendered frame.

It follows the configuration as stated: every matrix product takes its
operands rounded to the configuration's compute dtype and accumulates in
float32 with TF32 off; everything else is float32.  The rounding is
straight-through (the gradient of a rounded operand is the float32
cotangent, unrounded).  ``quant`` replaces that rounding, which is how the
control computes the same thing at a lower precision.

The random draws (stratified jitter, density noise, resampler jitter) are
taken from a ``torch.Generator`` in the order the method takes them, so a
generator seeded as the program's is replays the program's draws.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]
Net = Dict[str, torch.Tensor]
_SQRT2 = 1.4142135623730951
_TRIG = 100.0 * math.pi


def straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 operands (round to nearest even), float32 arithmetic."""
    return straight_through(x, x.to(torch.bfloat16).float())


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 operands with one scale per tensor (its largest
    magnitude at e4m3's 448): the control's precision."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return straight_through(x, (x / scale).to(torch.float8_e4m3fn).float()
                            * scale)


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


QUANTS = {"bfloat16": bf16, "float32": fp32, "fp8": fp8}


# ----------------------------------------------------------------- config


class Setup:
    """What the reference reads of a configuration dict."""

    def __init__(self, cfg: dict, rays_per_step: Optional[int] = None):
        nerf, tp, ds = cfg["nerf"], cfg["train_params"], cfg["dataset"]
        self.dd = nerf["type"] == "DDNerfModel"
        self.train, self.val = nerf["train"], nerf["validation"]
        self.rays = rays_per_step or self.train["num_random_rays"]
        self.near, self.far = float(ds["near"]), float(ds["far"])
        self.single_image = bool(ds["single_image_mode"])
        self.blender = ds["type"].lower() == "blender"
        self.tp = tp
        self.coefs = tp["loss_coeficients"]
        self.dist_reg = (min(max(1.0 / self.train["num_coarse"], 0.01), 0.12)
                         if tp.get("set_automatic_dist_reg_coeficient")
                         else tp["dist_reg_coeficient"])
        self.opt = cfg["optimizer"]
        self.iters = cfg["experiment"]["train_iters"]
        self.chunk = self.val["chunksize"]
        self.quant = QUANTS[cfg["parallel"]["compute_dtype"]]

    # schedules, in float32 as the method's numpy code evaluates them
    def lr(self, step: int) -> float:
        f = np.float32
        o = self.opt
        s = f(step)
        delay = (f(o["lr_delay_mult"]) + f(1.0 - o["lr_delay_mult"]) * np.sin(
            f(0.5 * np.pi) * np.clip(s / f(o["lr_delay_steps"]), 0.0, 1.0))
            if o["lr_delay_steps"] > 0 else f(1.0))
        t = np.clip(s / f(self.iters), f(0.0), f(1.0))
        lerp = np.exp(np.log(f(o["lr_init"])) * (f(1.0) - t)
                      + np.log(f(o["lr_final"])) * t)
        return float(f(delay * lerp))

    def smooth(self, step: int) -> float:
        f, tp = np.float32, self.tp
        if step < tp["finnish_smooth"]:
            d = (tp["gaussian_smooth_factor"] - tp["final_smooth"]) / tp["finnish_smooth"]
            return float(f(tp["gaussian_smooth_factor"]) - f(d) * f(step))
        return float(f(tp["final_smooth"]))

    def padding(self, step: int) -> bool:
        return bool(self.tp["pdf_padding"] and step < self.tp["max_pdf_pad_iters"])

    def eval_schedule(self) -> Tuple[float, bool]:
        """Smoothing and padding of a render after training."""
        flipped = self.tp["max_pdf_pad_iters"] < self.iters
        smooth = self.tp["final_smooth"] if flipped else self.tp["gaussian_smooth_factor"]
        return float(smooth), bool(self.tp["pdf_padding"] and not flipped)


# ------------------------------------------------------------------ network


def mlp(net: Net, ipe: torch.Tensor, dirs: torch.Tensor, q: Quant) -> torch.Tensor:
    """``ipe [N, S, 96]``, per-ray ``dirs [N, 27]`` -> ``[N, S, 4|6]`` =
    (rgb 3, density 1[, raw mu, raw sigma])."""
    def dense(x, name):
        return q(x) @ q(net[name + ".weight"]).T + net[name + ".bias"]

    x = ipe
    for i in range(8):
        x = torch.relu(dense(torch.cat([ipe, x], -1) if i == 5 else x,
                             f"layers_xyz.{i}"))
    feat = dense(x, "fc_feat")
    alpha = dense(feat, "fc_alpha")
    wd = net["layers_dir.0.weight"]
    hid = feat.shape[-1]
    dproj = q(dirs) @ q(wd[:, hid:]).T
    h = torch.relu(q(feat) @ q(wd[:, :hid]).T + dproj[:, None, :]
                   + net["layers_dir.0.bias"])
    outs = [dense(h, "fc_rgb"), alpha]
    if "fc_mu_sigma.weight" in net:
        outs.append(dense(h, "fc_mu_sigma"))
    return torch.cat(outs, -1)


def _wrap(x):
    return torch.where(x.abs() < _TRIG, x, torch.remainder(x, _TRIG))


def ipe(means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Integrated positional encoding over 16 levels, by the double-angle
    recurrence: ``[sin by (level, dim) | cos by (level, dim)]``."""
    s, c = torch.sin(_wrap(means)), torch.cos(_wrap(means))
    sins, coss, scale = [], [], 1.0
    for level in range(16):
        w = torch.exp((-0.5 * scale) * covs)
        sins.append(w * s)
        coss.append(w * c)
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        scale *= 4.0
    shape = means.shape[:-1] + (-1,)
    return torch.cat([torch.stack(sins, -2).reshape(shape),
                      torch.stack(coss, -2).reshape(shape)], -1)


def dirs_pe(d: torch.Tensor) -> torch.Tensor:
    v = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    freqs = 2.0 ** torch.arange(4, dtype=v.dtype, device=v.device)
    xb = v[:, None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xb), torch.cos(xb)], -2).reshape(v.shape[0], -1)
    return torch.cat([v, enc], -1)


def cone_gaussians(t, origins, dirs, radii):
    """Conical frustum sections as diagonal Gaussians ``[N, S, 3]``."""
    t0, t1 = t[:, :-1], t[:, 1:]
    mu, hw = (t0 + t1) / 2.0, (t1 - t0) / 2.0
    den = 3.0 * mu ** 2 + hw ** 2
    t_mean = mu + 2.0 * mu * hw ** 2 / den
    t_var = hw ** 2 / 3.0 - (4.0 / 15.0) * (hw ** 4 * (12.0 * mu ** 2 - hw ** 2)) / den ** 2
    r_var = radii ** 2 * (mu ** 2 / 4.0 + (5.0 / 12.0) * hw ** 2
                          - (4.0 / 15.0) * hw ** 4 / den)
    mag = torch.clamp(torch.sum(dirs ** 2, -1, keepdim=True), min=1e-10)
    means = dirs[:, None, :] * t_mean[..., None] + origins[:, None, :]
    covs = (t_var[..., None] * (dirs ** 2)[:, None, :]
            + r_var[..., None] * (1.0 - dirs ** 2 / mag)[:, None, :])
    return means, covs


# ------------------------------------------------------------------ draws


class Draws:
    """The method's random draws from one generator, in its order; no
    generator means no draws (a deterministic render)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.gen = generator

    def rand(self, shape, device):
        return torch.rand(shape, generator=self.gen, device=device)

    def randn(self, shape, device):
        return torch.randn(shape, generator=self.gen, device=device)


# --------------------------------------------------------------- sampling


def stratified(n, near, far, samples, perturb, draws: Draws, device):
    t = torch.linspace(0.0, 1.0, samples + 1, device=device)
    nv = torch.full((n, 1), near, device=device)
    fv = torch.full((n, 1), far, device=device)
    tv = nv * (1.0 - t) + fv * t
    if not perturb:
        return tv
    mids = 0.5 * (tv[:, 1:] + tv[:, :-1])
    upper = torch.cat([mids, tv[:, -1:]], -1)
    lower = torch.cat([tv[:, :1], mids], -1)
    tv = lower + (upper - lower) * draws.rand(tv.shape, device)
    return torch.cat([nv, tv[:, 1:-1], fv], -1)


def _filter(w, padding):
    wp = torch.cat([w[:, :1], w, w[:, -1:]], -1)
    if padding:
        m = torch.maximum(wp[:, :-1], wp[:, 1:])
        out = 0.5 * (m[:, :-1] + m[:, 1:])
    else:
        out = 0.8 * w + 0.1 * wp[:, :-2] + 0.1 * wp[:, 2:]
    return out + 0.01


def _cdf(w):
    pdf = w / torch.sum(w, -1, keepdim=True)
    c = torch.clamp(torch.cumsum(pdf[:, :-1], -1), max=1.0)
    return torch.cat([torch.zeros_like(c[:, :1]), c, torch.ones_like(c[:, :1])], -1)


def _section(u, fences):
    """The section of each ``u`` (count of inner fences <= u)."""
    return torch.sum(u[..., None] >= fences[:, None, 1:-1], -1)


def _pick(x, idx):
    return torch.gather(x, -1, idx)


@torch.no_grad()
def resample_mip(t, w, m, padding, det, draws: Draws):
    """mip-NeRF's inverse-CDF resampling of ``m`` fenceposts."""
    w = _filter(w.float(), padding)
    cdf = _cdf(w)
    n = t.shape[0]
    if det:
        u = torch.linspace(0.0, 1.0, m, device=t.device).expand(n, m)
    else:
        u = torch.arange(m, dtype=torch.float32, device=t.device) * (1.0 / m)
        u = torch.clamp(u + draws.rand((n, m), t.device) / (m + 1e-5), max=0.9999)
    i = _section(u, cdf)
    c0, c1 = _pick(cdf[:, :-1], i), _pick(cdf[:, 1:], i)
    b0, b1 = _pick(t[:, :-1], i), _pick(t[:, 1:], i)
    d = c1 - c0
    f = torch.clamp(torch.where(d > 0, (u - c0) / torch.where(d > 0, d, 1.0), 0.0), 0.0, 1.0)
    return b0 + f * (b1 - b0)


@torch.no_grad()
def resample_dd(t, w, mus, sig, inside, left, m, near, far, padding, det,
                draws: Draws):
    """DDNeRF's resampling of ``m`` fenceposts through each section's
    truncated Gaussian, the ends pinned to the scene's near and far."""
    w = _filter(w, padding)
    cdf = _cdf(w)
    n = t.shape[0]
    if det:
        u = torch.linspace(0.0, 0.9999, m, device=t.device).expand(n, m)
    else:
        u = torch.arange(m, dtype=torch.float32, device=t.device) * (1.0 / (m - 1))
        u = torch.clamp(u + draws.rand((n, m), t.device) / (m + 1e-5), 0.0, 0.9999)
    i = _section(u, cdf)
    c0, c1 = _pick(cdf[:, :-1], i), _pick(cdf[:, 1:], i)
    d = c1 - c0
    f = torch.clamp(torch.where(d > 0, (u - c0) / torch.where(d > 0, d, 1.0), 0.0), 0.0, 1.0)
    z = torch.clamp(f * _pick(inside, i) + _pick(left, i), max=0.999)
    z = _SQRT2 * torch.erfinv(2.0 * z - 1.0)
    x = torch.clamp(z * _pick(sig, i) + _pick(mus, i), 0.0, 0.99999)
    b0, b1 = _pick(t[:, :-1], i), _pick(t[:, 1:], i)
    out = b0 + x * (b1 - b0)
    out[:, 0], out[:, -1] = near, far
    return out


def _phi(x):
    return 0.5 * (1.0 + torch.erf(x / _SQRT2))


def tails(mus, sig):
    left = _phi(-mus / sig)
    return left, _phi((1.0 - mus) / sig) - left


# -------------------------------------------------------------- composite


def composite(raw, t, dirs, noise_std, draws: Draws, eps_last: bool):
    """Alpha compositing -> (rgb [N, 3], weights [N, S], pdf-normalized
    depth [N], accumulated opacity [N])."""
    mids = (t[:, 1:] + t[:, :-1]) / 2.0
    delta = (t[:, 1:] - t[:, :-1]) * torch.linalg.norm(dirs, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw[..., :3]) * (1.0 + 2.0 * 0.001) - 0.001
    density = raw[..., 3]
    if noise_std > 0.0 and draws.gen is not None:
        density = density + draws.randn(density.shape, density.device) * noise_std
    alpha = 1.0 - torch.exp(-F.softplus(density - 1.0) * delta)
    trans = torch.cat([torch.ones_like(alpha[:, :1]),
                       torch.cumprod(1.0 - alpha + 1e-10, -1)[:, :-1]], -1)
    w = alpha * trans
    rgb_map = torch.sum(w[..., None] * rgb, -2)
    if eps_last:
        w = torch.cat([w[:, :-1], w[:, -1:] + 1e-10], -1)
    depth = torch.sum(w / torch.sum(w, -1, keepdim=True) * mids, -1)
    return rgb_map, w, depth, torch.sum(w, -1)


def dp_loss(t1, t0, w1, w0, mus, sig, left, inside, filter_empty):
    """The depth-prediction loss: KL from the fine weights to the coarse
    truncated-Gaussian distribution at the fine fenceposts, per ray the
    mean over fine sections, averaged over the rays the fine weights do
    not leave empty."""
    eps = 1e-12
    keep = torch.sum(w1, 1) > 1e-10
    p0 = (w0 + eps) / torch.sum(w0 + eps, -1, keepdim=True)
    p1 = (w1 + eps) / torch.sum(w1 + eps, -1, keepdim=True)
    seg = t0[:, 1:] - t0[:, :-1]
    mu_ray, sig_ray = t0[:, :-1] + mus * seg, sig * seg
    c = torch.minimum(torch.cumsum(p0[:, :-1], -1), torch.ones(()).to(p0))
    c = torch.cat([torch.zeros_like(c[:, :1]), c, torch.ones_like(c[:, :1])], -1)
    i = torch.sum(t1[..., None] > t0[:, None, 1:-1], -1)  # strict
    x = (t1 - _pick(mu_ray, i)) / _pick(sig_ray, i)
    est = _pick(c[:, :-1], i) + (_phi(x) - _pick(left, i)) / _pick(inside, i) * _pick(p0, i)
    est = torch.minimum(est, torch.ones(()).to(est))
    e = torch.maximum(est[:, 1:] - est[:, :-1], torch.zeros(()).to(est))
    e = (e + eps) / torch.sum(e + eps, -1, keepdim=True)
    per_ray = torch.mean(p1 * (torch.log(p1) - torch.log(e)), -1)
    if filter_empty:
        return (torch.sum(torch.where(keep, per_ray, 0.0))
                / torch.clamp(torch.sum(keep), min=1))
    return torch.mean(per_ray)


# -------------------------------------------------------------- the render


def render_rays(s: Setup, nets: List[Net], origins, dirs, radii, mode: str,
                smooth: float, padding: bool, draws: Draws, q: Quant):
    """Both cycles over ``N`` rays -> ``{0: maps, 1: maps}``; ``mode``
    ``train`` adds the losses' terms."""
    mc = s.train if mode == "train" else s.val
    n, dev = origins.shape[0], origins.device
    pe = dirs_pe(dirs)
    radii = radii.reshape(-1, 1)

    def run(net, t):
        means, covs = cone_gaussians(t, origins, dirs, radii)
        return mlp(net, ipe(means, covs), pe, q)

    t0 = stratified(n, s.near, s.far, mc["num_coarse"], mc["perturb"], draws, dev)
    noise = mc["radiance_field_noise_std"]
    raw0 = run(nets[0], t0)
    rgb0, w0, depth0, acc0 = composite(raw0, t0, dirs, noise, draws, s.blender)
    out = {0: {"rgb": rgb0, "weights": w0}}
    m = mc["num_fine"] + 1
    if not s.dd:
        t1 = resample_mip(t0, w0, m, padding, not mc["perturb"], draws)
        raw1 = run(nets[0], t1)
    else:
        mus = torch.sigmoid(raw0[..., 4])
        sig = torch.sigmoid(raw0[..., 5]) + 0.001
        left_s, inside_s = tails(mus, sig * smooth)
        t1 = resample_dd(t0, w0, mus, sig * smooth, inside_s, left_s, m,
                         s.near, s.far, padding, not mc["perturb"], draws)
        raw1 = run(nets[1], t1)
    rgb1, w1, depth1, acc1 = composite(raw1, t1, dirs, noise, draws, s.blender)
    out[1] = {"rgb": rgb1, "weights": w1,
              "disp": 1.0 / torch.clamp(depth1 / acc1, min=1e-10)}
    if mode == "train" and s.dd:
        raw_mu, raw_sig = raw0[..., 4], raw0[..., 5]
        sig_loss = torch.sum(raw_sig ** 2) / n
        mus_loss = torch.sum(raw_mu ** 2) / n
        left, inside = tails(mus, sig)
        dp = dp_loss(t1, t0.detach(), w1.detach(), w0, mus, sig, left.detach(),
                     inside.detach(), s.blender) * (t1.shape[-1] - 1)
        out[1]["dp_loss"] = dp + s.dist_reg * (mus_loss + sig_loss)
    return out


# ----------------------------------------------------------- training


class Adam:
    """Adam with betas (0.9, 0.999) and eps 1e-8, one state per leaf."""

    def __init__(self, params: List[torch.Tensor]):
        self.params = params
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(lr / c1 * m / (torch.sqrt(v) / math.sqrt(c2) + 1e-8))


def draw_batch(store: torch.Tensor, rays: int, single_image: bool,
               draws: Draws) -> torch.Tensor:
    """The step's rows of the ray store ``[views, pixels, 10]``."""
    n_img, n_pix, _ = store.shape
    flat = store.reshape(n_img * n_pix, -1)
    dev = store.device
    if single_image:
        img = torch.randint(0, n_img, (), generator=draws.gen, device=dev)
        idx = torch.randint(0, n_pix, (rays,), generator=draws.gen, device=dev)
        return flat[img * n_pix + idx]
    return flat[torch.randint(0, n_img * n_pix, (rays,), generator=draws.gen,
                              device=dev)]


def train_loss(s: Setup, nets: List[Net], rows: torch.Tensor, step: int,
               draws: Draws, q: Quant) -> torch.Tensor:
    out = render_rays(s, nets, rows[:, 0:3], rows[:, 3:6], rows[:, 6:7],
                      "train", s.smooth(step), s.padding(step), draws, q)
    target = rows[:, 7:10]
    loss = (s.coefs[0] * torch.mean((out[0]["rgb"] - target) ** 2)
            + s.coefs[1] * torch.mean((out[1]["rgb"] - target) ** 2))
    if s.dd:
        loss = loss + s.tp["dp_coeficient"] * out[1]["dp_loss"]
    return loss


def follow_training(s: Setup, weights: Dict[str, Net], store: torch.Tensor,
                    generator: torch.Generator, first_step: int, steps: int,
                    q: Quant) -> dict:
    """``steps`` training steps from ``weights`` at iteration
    ``first_step``: each step draws its rays from ``store``, takes the
    loss and its gradients and applies Adam at ``lr(step)``.  Returns
    ``losses`` (one per step), ``grads`` (each step's gradient, per leaf
    name) and ``params`` (the leaves after the last step)."""
    names = [(net, leaf) for net in weights for leaf in weights[net]]
    params = [weights[net][leaf].detach().clone().requires_grad_(True)
              for net, leaf in names]
    nets, at = [], 0
    for net in weights:
        k = len(weights[net])
        nets.append({leaf: p for (_, leaf), p in zip(names[at:at + k], params[at:at + k])})
        at += k
    adam = Adam(params)
    draws = Draws(generator)
    losses, grads = [], []
    for j in range(steps):
        step = first_step + j
        rows = draw_batch(store, s.rays, s.single_image, draws)
        loss = train_loss(s, nets, rows, step, draws, q)
        g = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        grads.append({f"{net}.{leaf}": x for (net, leaf), x in zip(names, g)})
        adam.step(list(g), s.lr(step))
    return {"losses": losses, "grads": grads,
            "params": {f"{net}.{leaf}": p.detach() for (net, leaf), p in zip(names, params)}}


# ------------------------------------------------------------- the frame


def camera_rays(pose: np.ndarray, h: int, w: int, focal: float, device):
    """One ray per pixel of a [4, 4] camera-to-world pose, with the base
    radius from the spacing of neighbouring pixel directions; a zero
    origin or direction component is nudged to 1e-5 (the method's
    ray-generation quirk)."""
    c2w = torch.as_tensor(pose, dtype=torch.float32, device=device)
    jj, ii = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    cam = torch.stack([(ii - w * 0.5) / focal, -(jj - h * 0.5) / focal,
                       -torch.ones_like(ii)], -1)
    d = torch.sum(cam[..., None, :] * c2w[:3, :3], -1)
    o = torch.broadcast_to(c2w[:3, -1], d.shape)
    o = torch.where(o == 0, 1e-5, o)
    d = torch.where(d == 0, 1e-5, d)
    dx = torch.sqrt(torch.sum((cam[:-1] - cam[1:]) ** 2, -1))
    dx = torch.cat([dx, dx[-2:-1, :]], 0)
    return o.reshape(-1, 3), d.reshape(-1, 3), (dx * 2.0 / math.sqrt(12.0)).reshape(-1, 1)


@torch.no_grad()
def render_frame(s: Setup, weights: Dict[str, Net], pose: np.ndarray, h: int,
                 w: int, focal: float, q: Quant, device,
                 noise_seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A video frame: the fine rgb and disparity of every pixel, in chunks
    of the validation chunk size, quantized to uint8 (rgb clipped and
    truncated; disparity normalized by the frame's range).  The density
    noise comes from one generator seeded ``noise_seed`` per frame."""
    nets = list(weights.values())
    smooth, padding = s.eval_schedule()
    o, d, r = camera_rays(pose, h, w, focal, device)
    draws = Draws(torch.Generator(device=device).manual_seed(noise_seed))
    rgb, disp = [], []
    for a in range(0, o.shape[0], s.chunk):
        out = render_rays(s, nets, o[a:a + s.chunk], d[a:a + s.chunk],
                          r[a:a + s.chunk], "render", smooth, padding, draws, q)
        rgb.append(out[1]["rgb"])
        disp.append(out[1]["disp"])
    rgb, disp = torch.cat(rgb), torch.cat(disp)
    rgb_u8 = (torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
    disp = torch.nan_to_num(disp, nan=0.0, posinf=0.0, neginf=0.0)
    lo, span = disp.min(), disp.max() - disp.min()
    norm = (disp - lo) / torch.where(span > 0, span, torch.ones_like(span))
    disp_u8 = (torch.clamp(norm, 0.0, 1.0) * 255).to(torch.uint8)
    return rgb_u8.cpu().numpy().reshape(h, w, 3), disp_u8.cpu().numpy().reshape(h, w)
