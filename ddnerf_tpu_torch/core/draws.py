"""The random draws of a render (stratified jitter, resampler jitter,
density noise), and what a sharded render does to them.

Every draw of the pipeline is ``[N, ...]`` over the N rays it renders.  A
render sharded over ranks (``render/renderer.py``) gives each rank a slice
of a chunk's rays and says so with ``rows = (start, stop, total)`` (the
rays' ``RayBatch.rows``): each draw is then made for the whole chunk of
``total`` rays, from the same generator state on every rank, and rows
``[start, stop)`` are kept, padded with the last drawn row to the ``N`` the
caller asked for (a rank's share of a ragged chunk is padded the same
way).  So a ray gets the same jitter and noise whatever the number of
ranks, as in the JAX package, whose sharded render draws one key's values
over the global array.  Without ``rows`` :func:`rand` / :func:`randn` are
``torch.rand`` / ``torch.randn``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Rows = Optional[Tuple[int, int, int]]


def _draw(fn, shape, generator, dtype, device, rows: Rows) -> torch.Tensor:
    shape = tuple(shape)
    if rows is None:
        return fn(shape, generator=generator, dtype=dtype, device=device)
    start, stop, total = rows
    full = fn((total, *shape[1:]), generator=generator, dtype=dtype,
              device=device)
    part = full[start:stop] if stop > start else full[-1:]
    pad = shape[0] - part.shape[0]
    if pad > 0:
        part = torch.cat([part, part[-1:].expand(pad, *shape[1:])])
    return part


def rand(shape, *, generator, dtype=None, device=None,
         rows: Rows = None) -> torch.Tensor:
    return _draw(torch.rand, shape, generator, dtype, device, rows)


def randn(shape, *, generator, dtype=None, device=None,
          rows: Rows = None) -> torch.Tensor:
    return _draw(torch.randn, shape, generator, dtype, device, rows)
