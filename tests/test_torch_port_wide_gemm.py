"""The plain pieces around the wide plan's GEMM (``csrc/fused_mlp_wide.cu``)
that run on the CPU.

* ``reference.tf32_planes_t_reference``, the layout of the transposed TF32
  planes the float32 backward's chain writes for its weight gradients,
  bit for bit ``reference.tf32_split`` of the transposed slab
  (``chip_smoke.py`` phase 19 holds the kernel's planes to it on the card);
* ``chip_smoke.py::library_gemms``, the library yardstick's products:
  one per GEMM the wide plan launches, at its shapes, for the fused plans'
  widths too."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref

F32_MAX = np.finfo(np.float32).max


def _slab(rng, n, cols):
    """Random float32 cotangents with the split's hard cases mixed in: TF32
    ties, subnormals, values that round to infinity, signed zeros."""
    g = rng.standard_normal((n, cols)).astype(np.float32)
    special = np.array([1.0 + 2 ** -11, -(1.0 + 2 ** -11), 2.0 ** -140,
                        -(2.0 ** -130), F32_MAX, -F32_MAX, 0.0, -0.0],
                       dtype=np.float32)
    flat = g.reshape(-1)
    at = rng.choice(flat.size, min(flat.size, 64), replace=False)
    flat[at] = special[np.arange(at.size) % special.size]
    return torch.from_numpy(g)


@pytest.mark.parametrize("n,cols", [(1, 16), (33, 64), (333, 640)])
def test_tf32_planes_t_reference_is_the_transposed_split(n, cols):
    """Planes [2, cols, ldt], ldt the least multiple of 32 from n: big and
    small parts of g.T bit for bit ``tf32_split``'s, zero past n."""
    g = _slab(np.random.default_rng(n + cols), n, cols)
    planes = ref.tf32_planes_t_reference(g)
    ldt = planes.shape[2]
    assert planes.shape[:2] == (2, cols) and ldt % 32 == 0
    assert n <= ldt < n + 32
    big, small = ref.tf32_split(g.T.contiguous())
    for got, want in ((planes[0, :, :n], big), (planes[1, :, :n], small)):
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.view(torch.int32))
    assert not planes[..., n:].any()
    # The parts are TF32 values; big + small is g to 2^-22 where big is
    # finite and g no smaller than 2^-100 (tf32_split's own bound).
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    x = g.T.double()
    keep = torch.isfinite(planes[0, :, :n]) & (x.abs() >= 2.0 ** -100)
    back = (planes[0, :, :n].double() + planes[1, :, :n].double())[keep]
    assert ((back - x[keep]).abs() <= 2.0 ** -22 * x[keep].abs()).all()


@pytest.mark.parametrize("hidden", [256, 600, 1024])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_library_yardstick_takes_the_wide_plans_products(hidden, kind):
    """The products ``library_ms`` times for a row of either plan are the
    wide plan's launches at kernel width Hp (at 256 the fused plan's
    width): forward 11 (the trunk, the skip layer's IPE | x as one K
    range, the dir layer's 144 rows, the heads' 16), 8 Hp^2 + 336 Hp +
    2048 multiply-adds a row; backward the chain
    (10 products, 8 Hp^2 + 129 Hp + 2048) and the weight gradients (13,
    8 Hp^2 + 321 Hp + 2048), each weight gradient A^T over the rows."""
    rows = 7
    hp = fk.kernel_width(hidden)
    gemms = cs.library_gemms(hidden, rows, kind)
    macs = sum(m * k * n for m, k, n, _ in gemms) // rows
    if kind == "fwd":
        assert len(gemms) == 11 and not any(t for *_, t in gemms)
        assert all(m == rows for m, *_ in gemms)
        assert macs == 8 * hp ** 2 + 336 * hp + 2048
        assert gemms[5][1] == fk.IPE_DIM + hp
        assert [g[2] for g in gemms[-2:]] == [fk.DIR_LAYER_ROWS,
                                              fk.HEAD_ROWS]
    else:
        chain, wgrad = gemms[:10], gemms[10:]
        assert len(wgrad) == 13
        assert not any(t for *_, t in chain) and all(t for *_, t in wgrad)
        assert all(k == rows for _, k, _, _ in wgrad)
        assert (sum(m * k * n for m, k, n, _ in chain) // rows
                == 8 * hp ** 2 + 129 * hp + 2048)
        assert (sum(m * k * n for m, k, n, _ in wgrad) // rows
                == 8 * hp ** 2 + 321 * hp + 2048)
