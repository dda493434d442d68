"""The float32 weight pack's TF32 planes (``kernels/fused_mlp.py::
with_tf32_planes``), on the CPU: the plain split of
``kernels/reference.py`` against a by-hand numpy definition of
``cvt.rna.tf32.f32`` (round to nearest, ties away from zero, to ten
mantissa bits), the planes and their transposed copies against the
network's weights at several widths, the TMA alignment of every offset,
and the gradient layout's round trip.  The card holds the split kernel to
this plain version bit for bit (``chip_smoke.py`` phase 18)."""

import numpy as np
import pytest
import torch

from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

F32_MAX = float(np.finfo(np.float32).max)
TINY = float(np.finfo(np.float32).tiny)  # 2^-126, the smallest normal


def _tf32_by_hand(x: np.ndarray) -> np.ndarray:
    """The TF32 value nearest each float32 of ``x``, ties away from zero,
    in float64 arithmetic: a multiple of the TF32 unit 2^(e - 10) of the
    binade [2^e, 2^(e+1)) (2^-136 below the smallest normal), infinity
    past the largest TF32 value."""
    a = np.abs(x.astype(np.float64))
    _, ex = np.frexp(np.where(a > 0, a, 1.0))
    unit = np.where(a < TINY, 2.0 ** -136, np.ldexp(1.0, ex - 11))
    r = np.floor(a / unit + 0.5) * unit
    out = np.copysign(r, x.astype(np.float64))
    with np.errstate(over="ignore"):
        return np.where(np.isfinite(x), out, x).astype(np.float32)


def _values(rng) -> np.ndarray:
    units = np.ldexp(1.0, rng.integers(-126, 118, 200) - 10)
    ties = (rng.integers(0, 1 << 10, 200) + 1024 + 0.5) * units  # k + 1/2
    bits = rng.integers(0, 0x7F800000, 2000, dtype=np.int64)
    spread = bits.astype(np.uint32).view(np.float32)
    sub = rng.integers(1, 1 << 23, 300, dtype=np.int64).astype(
        np.uint32).view(np.float32)  # subnormals
    sub_ties = (rng.integers(0, 1 << 10, 50) + 0.5) * 2.0 ** -136
    near_max = np.nextafter(np.float32(F32_MAX),
                            np.float32(0)) - rng.integers(0, 1 << 14, 50) \
        * np.float32(2.0 ** 104)
    edges = [0.0, TINY, F32_MAX, (2 - 2 ** -11) * 2.0 ** 127,
             (2 - 2 ** -10) * 2.0 ** 127, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11]
    x = np.concatenate([ties, spread, sub, sub_ties, near_max, edges,
                        rng.standard_normal(500)]).astype(np.float32)
    return np.concatenate([x, -x])


def test_tf32_round_is_cvt_rna():
    """Signs, ties (away from zero), subnormals, the f32 maximum (which
    rounds to infinity) and random bit patterns: the plain rounding equals
    the by-hand definition bit for bit, and keeps 13 zero low bits."""
    x = _values(np.random.default_rng(0))
    got = ref.tf32_round(torch.from_numpy(x)).numpy()
    want = _tf32_by_hand(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # Ties go away from zero; the f32 maximum goes to infinity.
    tie = np.float32(1.0 + 2 ** -11)
    assert ref.tf32_round(torch.tensor([tie, -tie])).tolist() == [
        1.0 + 2 ** -10, -(1.0 + 2 ** -10)]
    assert ref.tf32_round(torch.tensor([F32_MAX])).item() == float("inf")


def test_tf32_split_parts_and_error():
    """big and small are TF32 values (13 zero low bits), big the rounding
    of x, small that of x - big, and |x - (big + small)| <= 2^-22 |x| for
    every x whose big is finite and whose x - big is no subnormal (|x| >=
    2^-100: below that small's unit is the subnormals' 2^-136)."""
    x = _values(np.random.default_rng(1))
    x = x[np.abs(x) < (2 - 2 ** -11) * 2.0 ** 127]
    big, small = ref.tf32_split(torch.from_numpy(x))
    for part in (big, small):
        assert not (part.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(big.numpy(), _tf32_by_hand(x))
    np.testing.assert_array_equal(
        small.numpy(), _tf32_by_hand(x - big.numpy()))
    err = np.abs(x.astype(np.float64) - big.numpy().astype(np.float64)
                 - small.numpy().astype(np.float64))
    normal = np.abs(x) >= 2.0 ** -100
    assert normal.sum() > 3000
    assert (err <= 2.0 ** -22 * np.abs(x.astype(np.float64)))[normal].all()


def _mats(kw, plane, width, transposed=False):
    """The 12 matrices of plane ``plane`` of ``kw.planes`` ([rows, cols],
    or [cols, rows] in a transposed plane)."""
    size = fk.plane_size(kw.w_off)
    t = kw.planes[plane * size:(plane + 1) * size]
    ends = (*kw.w_off[1:], size)
    out = []
    for o, e, r in zip(kw.w_off, ends, fk.packed_rows(width)):
        m = t[o:e].view(-1, r) if transposed else t[o:e].view(r, -1)
        out.append(m.T if transposed else m)
    return out


@pytest.mark.parametrize("hidden", [48, 96, 256, 320, 512])
def test_f32_pack_planes_hold_the_weights(hidden):
    """At float32 the pack carries five planes in one buffer: the packed
    weights (``w``, a view of the first), their TF32 big and small parts
    and both transposed per matrix.  Each plane's matrices hold the
    network's weights split (padding zero), every matrix and plane starts
    on 16 bytes with rows of a multiple of 16 bytes (TMA's alignment, in
    both orientations), and ``unpack_grads`` of ``w`` gives every
    parameter back bitwise."""
    net = DepthMipMLP(hidden_size=hidden, compute_dtype=torch.float32,
                      generator=torch.Generator().manual_seed(hidden))
    kw = fk.pack_weights(net)
    width = fk.kernel_width(hidden)
    size = fk.plane_size(kw.w_off)
    assert kw.planes.numel() == len(fk.TF32_PLANES) * size
    assert kw.w.data_ptr() == kw.planes.data_ptr() and kw.w.numel() == size
    assert size % 4 == 0 and all(o % 4 == 0 for o in kw.w_off)
    rows = fk.packed_rows(width)
    ends = (*kw.w_off[1:], size)
    for o, e, r in zip(kw.w_off, ends, rows):
        assert (e - o) % r == 0
        assert ((e - o) // r) * 4 % 16 == 0 and r * 4 % 16 == 0
    w = _mats(kw, 0, width)
    big, small = _mats(kw, 1, width), _mats(kw, 2, width)
    big_t, small_t = (_mats(kw, 3, width, True), _mats(kw, 4, width, True))
    for i in range(len(w)):
        x = w[i].numpy()
        np.testing.assert_array_equal(big[i].numpy(), _tf32_by_hand(x))
        np.testing.assert_array_equal(small[i].numpy(),
                                      _tf32_by_hand(x - big[i].numpy()))
        assert torch.equal(big_t[i], big[i]) and torch.equal(small_t[i],
                                                             small[i])
    back = fk.unpack_grads(net, kw, kw.w, kw.b)
    for name, p in net.named_parameters():
        assert torch.equal(back[name], p.detach()), name
    # The trunk's padded rows and columns are zero in every plane.
    if width > hidden:
        for m in (w[1], big[1], small[1]):
            assert not m[hidden:].any() and not m[:, hidden:].any()


def test_f32_pack_without_planes_is_refused():
    """A float32 pack whose ``w`` is not the first plane of its buffer (a
    pack changed after the split) cannot reach a float32 kernel, and the
    bf16 pack carries no planes."""
    net = MipMLP(hidden_size=64, compute_dtype=torch.float32)
    kw = fk.pack_weights(net)
    assert fk._weights_ptr(kw, torch.float32) == kw.planes.data_ptr()
    with pytest.raises(ValueError, match="TF32 planes"):
        fk._weights_ptr(kw._replace(w=kw.w.clone()), torch.float32)
    again = fk.with_tf32_planes(kw._replace(w=kw.w.clone(), planes=None))
    assert torch.equal(again.planes, kw.planes)
    bf16 = fk.pack_weights(MipMLP(hidden_size=64,
                                  compute_dtype=torch.bfloat16))
    assert bf16.planes is None and bf16.w.dtype == torch.bfloat16
