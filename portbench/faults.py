"""Faults planted in the program under test, each a context manager, to show
that the comparison which decides ``correct`` catches them
(``test_portbench_faults.py`` on the CPU, ``calibrate.py --fault`` on the
card at a cell's size).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def state_unchanged():
    """Every optimizer step returns the parameters as they were."""
    return _patched(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)


def half_batch():
    """A training step's loss over half of its rays: the first half of the
    drawn batch stands in for the second, so the mean is the first half's."""
    from ddnerf_tpu_torch.train import step

    def make(orig):
        def draw(cfg, store, generator):
            batch = orig(cfg, store, generator)
            n = batch["origins"].shape[0] // 2
            return {k: torch.cat([v[:n], v[:n]]) for k, v in batch.items()}
        return draw

    return _patched(step, "_draw_batch", make)


def loss_altered():
    """Each colour loss one percent high where it is computed."""
    from ddnerf_tpu_torch.train import step

    return _patched(step, "img2mse", lambda orig: lambda a, b: orig(a, b) * 1.01)


def frame_half():
    """Each render chunk's second half of rays takes the first half's maps."""
    from ddnerf_tpu_torch.models.nerf import NerfPipeline

    def make(orig):
        def render_rays(self, rays, sched, mode="render", generator=None):
            out = orig(self, rays, sched, mode, generator)
            for maps in out.values():
                for k, v in maps.items():
                    if v.dim() > 0 and v.shape[0] > 1:
                        n = v.shape[0] // 2
                        maps[k] = torch.cat([v[:n], v[:v.shape[0] - n]])
            return out
        return render_rays

    return _patched(NerfPipeline, "render_rays", make)


def frame_altered():
    """Each frame's uint8 rgb two levels high where it is quantized."""
    from ddnerf_tpu_torch.render import renderer

    def make(orig):
        def quantize(rgb, disp):
            rgb_u8, disp_u8 = orig(rgb, disp)
            return torch.clamp(rgb_u8.int() + 2, max=255).to(torch.uint8), disp_u8
        return quantize

    return _patched(renderer, "quantize_video_frame", make)


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "loss_altered": loss_altered}
RENDER = {"frame_half": frame_half, "frame_altered": frame_altered}
