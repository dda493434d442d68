"""The relu masks as bit words (``csrc/mask_bits.cuh``): the stash forward
B1s writes them, B2's cotangent chain applies them instead of reading the
bf16 stash.

On the CPU, the layout's plain definition (``kernels/reference.py``):
``pack_mask_bits`` and ``unpack_mask_bits`` undo each other, columns past
the mask's width and rows past its end read 0, a bit sits where the wgmma
accumulator fragment puts it, and an activation that rounds to a bf16 zero
(a float32 subnormal) gets a 0 bit where a bf16 subnormal gets a 1.

Marked ``cuda`` (skipped without a card, decided in a fixture): B1s's words
equal the plain packing of its own stash (``trunk > 0``, ``h > 0``) at every
width, 96 and 320 zero-padded, for K 32 / 33 / 13 below one tile and above
132 tiles, both heads, and a bf16 subnormal activation gets a 1 bit where
one that rounds to 0 gets a 0; a single bit flipped in the words changes B2's
cotangent at that element and in the rows the chain carries it to, and
nowhere else (so the chain reads the bits, not the stash); and
``chain_mask_bits`` counts with ``fused_mlp_bwd``, eagerly and under
capture, and never for the float32 or wide plans.

On a GPU machine:  python -m pytest tests/test_torch_port_mask_bits.py -m cuda
"""

import pytest
import torch

from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

WIDTHS = (64, 128, 192, 256, 384, 512)


def _masks(n, width, seed, dir_width=128):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(ref.NUM_RELU, n, width, generator=gen) < 0.5,
            torch.rand(n, dir_width, generator=gen) < 0.5)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", [1, 64, 150])
def test_pack_and_unpack_undo_each_other(width, n):
    trunk, h = _masks(n, width, width + n)
    words = ref.pack_mask_bits(trunk, h, width)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == ref.mask_bits_shape(n, width)
    assert words.shape[1] * 32 == ref.MASK_ROWS * (8 * width + 128)
    got_trunk, got_h = ref.unpack_mask_bits(words, n, width)
    assert torch.equal(got_trunk, trunk) and torch.equal(got_h, h)
    assert torch.equal(ref.pack_mask_bits(got_trunk, got_h, width), words)


def test_columns_past_the_width_and_rows_past_the_end_read_zero():
    """A width-96 mask packed at kernel width 128, 150 rows: columns 96..127
    and rows 150..191 of the three groups unpack as 0."""
    trunk = torch.ones(ref.NUM_RELU, 150, 96, dtype=torch.bool)
    h = torch.ones(150, 128, dtype=torch.bool)
    words = ref.pack_mask_bits(trunk, h, 128)
    got_trunk, got_h = ref.unpack_mask_bits(words, 192, 128)
    assert got_trunk[:, :150, :96].all() and got_h[:150].all()
    assert not got_trunk[:, :, 96:].any()
    assert not got_trunk[:, 150:].any() and not got_h[150:].any()


# (mask, row, column) -> (word, bit) at width 256 (C = 4 words a thread for
# x0..x7, 2 for h, whose region starts at word 128 * 4 * 8): row 16 w + 8
# half + g and column 64 c + 8 i + 2 q + e are bit 16 e + 15 - (2 i + half)
# of word c of thread 32 w + 4 g + q.
@pytest.mark.parametrize("mask,row,col,word,bit", [
    (0, 0, 0, 0, 15),
    (0, 0, 1, 0, 31),         # e = 1
    (0, 8, 0, 0, 14),         # half = 1
    (0, 0, 8, 0, 13),         # i = 1
    (0, 0, 64, 1, 15),        # c = 1
    (0, 0, 2, 4, 15),         # q = 1: thread 1
    (0, 1, 0, 16, 15),        # g = 1: thread 4
    (0, 16, 0, 128, 15),      # w = 1: thread 32
    (3, 63, 255, 3 * 512 + 127 * 4 + 3, 16),
    (8, 9, 70, 4096 + 7 * 2 + 1, 14),  # h: half 1, g 1, c 1, q 3: thread 7
])
def test_a_bit_sits_where_the_accumulator_fragment_puts_it(mask, row, col,
                                                           word, bit):
    trunk = torch.zeros(ref.NUM_RELU, 64, 256, dtype=torch.bool)
    h = torch.zeros(64, 128, dtype=torch.bool)
    (h if mask == 8 else trunk[mask])[row, col] = True
    words = ref.pack_mask_bits(trunk, h, 256)[0]
    want = torch.zeros_like(words)
    want[word] = (1 << bit) if bit < 31 else -(1 << 31)
    assert torch.equal(words, want)


def test_a_value_that_rounds_to_a_bf16_zero_gets_a_zero_bit():
    """The bit is the rounded (relu'd, so never negative) bf16 value's
    ``> 0``: a float32 subnormal at or below half of bf16's least subnormal
    rounds to 0 and gets a 0 bit; a bf16 subnormal gets a 1, as do the
    normals: the bit is 0 exactly where the bf16 value is 0."""
    values = torch.tensor([2.0 ** -140, 2.0 ** -134, 2.0 ** -133,
                           2.0 ** -130, 1e-38, 2.0 ** -126, 3.0, 0.0])
    stashed = torch.zeros(ref.NUM_RELU, 1, 64)
    stashed[5, 0, :len(values)] = values
    bf16 = stashed.to(torch.bfloat16)
    words = ref.pack_mask_bits(bf16 > 0, torch.zeros(1, 128, dtype=torch.bool),
                               64)
    got = ref.unpack_mask_bits(words, 1, 64)[0]
    assert got[5, 0, :len(values)].tolist() == [False, False, True, True,
                                                True, True, True, False]
    assert torch.equal(got, bf16 != 0)


def test_the_plain_forward_leaves_the_bits_to_the_kernels():
    """On the CPU the stash forward is the plain version, whose backward
    reads the stash itself: it makes no words."""
    net = MipMLP(hidden_size=64, compute_dtype=torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    ipe = torch.rand(12, 96)
    dirs = torch.rand(4, 27)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, 3, stash=True)
    assert stash.bits is None
    grads = fk.fused_mlp_backward(net, ipe, dirs, torch.randn(12, 4), 3,
                                  stash)
    assert set(grads) == {name for name, _ in net.named_parameters()}


# ------------------------------------------------------------------ card

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(cls, hidden, rays, k, seed, device):
    gen = torch.Generator().manual_seed(seed)
    net = cls(hidden_size=hidden, compute_dtype=torch.bfloat16,
              generator=gen).to(device)
    n = rays * k
    ipe = (torch.rand(n, 96, generator=gen) * 2 - 1).to(device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    g = torch.randn(n, net.out_dim, generator=gen).to(device)
    return net, ipe, dirs, g


def _shapes():
    """(hidden, rays, k): each width, 96 and 320 zero-padded, at K 32, 33
    and 13, below one 128-row tile and above 132 of them."""
    return [(hidden, rays, k)
            for hidden in (64, 96, 128, 192, 256, 320, 384, 512)
            for k in (32, 33, 13)
            for rays in (3, 132 * 128 // k + 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,rays,k", _shapes())
@pytest.mark.parametrize("cls", [DepthMipMLP, MipMLP])
def test_the_forward_writes_the_plain_packing_of_its_stash(device, cls,
                                                          hidden, rays, k):
    net, ipe, dirs, _ = _case(cls, hidden, rays, k, hidden + rays + k,
                              device)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    width = fk.kernel_width(hidden)
    want = ref.pack_mask_bits(stash.trunk[:ref.NUM_RELU] > 0, stash.h > 0,
                              width)
    assert stash.bits.dtype == torch.int32
    assert torch.equal(stash.bits, want)
    # Not all alike: the masks carry information in every region.
    trunk, h = ref.unpack_mask_bits(stash.bits, rays * k, width)
    assert trunk[:, :, :hidden].any() and not trunk[:, :, :hidden].all()
    assert h.any() and not h.all()


@pytest.mark.cuda
def test_a_subnormal_activation_gets_a_one_bit(device):
    """h = relu(dirs @ Wd_dirs) with one weight of 2^-64 and dirs of 2^-66
    or 2^-70: a bf16 subnormal 2^-130 in the stash (bit 1), or 2^-134,
    which rounds to 0 (bit 0)."""
    rays, k = 8, 4
    net, ipe, _, _ = _case(MipMLP, 64, rays, k, 5, device)
    with torch.no_grad():
        net.layers_dir[0].weight.zero_()
        net.layers_dir[0].weight[:, 64] = 2.0 ** -64
        net.layers_dir[0].bias.zero_()
    dirs = torch.zeros(rays, 27, device=device)
    dirs[0::2, 0] = 2.0 ** -66
    dirs[1::2, 0] = 2.0 ** -70
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    h = stash.h.float().view(rays, k, 128)
    assert (h[0::2] == 2.0 ** -130).all() and not h[1::2].any()
    assert torch.equal(stash.bits, ref.pack_mask_bits(
        stash.trunk[:ref.NUM_RELU] > 0, stash.h > 0, 64))
    h_bits = ref.unpack_mask_bits(stash.bits, rays * k, 64)[1]
    h_bits = h_bits.view(rays, k, 128)
    assert h_bits[0::2].all() and not h_bits[1::2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [8, 7, 5, 0])
@pytest.mark.parametrize("hidden", [128, 256, 384, 512])
def test_a_flipped_bit_moves_the_chain_at_that_element(device, hidden, mask):
    """One bit of x_mask (8: h) flipped in the words, the stash unchanged:
    B2's cotangent of that mask differs from the unflipped run at exactly
    that element; the cotangents the chain computed before it are equal,
    and those after it differ only in that row."""
    import chip_smoke as cs

    rays, k = 40, 33
    net, ipe, dirs, g = _case(DepthMipMLP, hidden, rays, k, hidden + mask,
                              device)
    n, width = rays * k, fk.kernel_width(hidden)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    trunk, h = ref.unpack_mask_bits(stash.bits, n, width)
    flipped = (h if mask == 8 else trunk[mask])
    row, col = n // 2 + 3, (7 * hidden) // 9 if mask != 8 else 77
    flipped[row, col] = ~flipped[row, col]
    bits = ref.pack_mask_bits(trunk, h, width)
    assert (bits != stash.bits).sum().item() == 1
    slabs = {}
    for name, words in (("sound", stash.bits), ("flipped", bits)):
        _, _, ws, _ = cs._b2_launch(torch, net, ipe, dirs, g, k,
                                    stash._replace(bits=words), False)
        slabs[name] = cs._b2_slabs(torch, ws, n, width)
    sound, moved = slabs["sound"], slabs["flipped"]
    # The chain's order: g_h (gd, and ghf in f32), g_feat (gt[8]), g_7 ..
    # g_0 (gt[7] .. gt[0]).
    order = [("gd", None), ("gt", 8)] + [("gt", i) for i in range(7, -1, -1)]
    at = 0 if mask == 8 else order.index(("gt", mask))
    assert torch.equal(sound["gs"], moved["gs"])
    for i, (name, slab) in enumerate(order):
        a = sound[name] if slab is None else sound[name][slab]
        b = moved[name] if slab is None else moved[name][slab]
        diff = (a != b).nonzero().tolist()
        if i < at:
            assert not diff, (name, slab)
        elif i == at:
            assert diff == [[row, col]], (name, slab, diff[:4])
        else:
            assert {r for r, _ in diff} <= {row}, (name, slab)
    ghf = (sound["ghf"] != moved["ghf"]).nonzero().tolist()
    assert ghf == ([[row, col]] if mask == 8 else [])


@pytest.mark.cuda
def test_chain_mask_bits_counts_each_bf16_backward_eager_and_captured(device):
    net, ipe, dirs, g = _case(DepthMipMLP, 256, 64, 32, 0, device)
    k = 32
    before = dict(fk.LAUNCHES)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    eager = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    torch.cuda.synchronize()
    assert {x: fk.LAUNCHES[x] - before[x] for x in before} == {
        **dict.fromkeys(before, 0), "fused_mlp_fwd_stash": 1,
        "fused_mlp_bwd": 1, "chain_mask_bits": 1}

    launches, captured = dict(fk.LAUNCHES), dict(fk.CAPTURED)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
        grads = fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    assert fk.LAUNCHES == launches
    assert {x: fk.CAPTURED[x] - captured[x] for x in captured} == {
        **dict.fromkeys(captured, 0), "fused_mlp_fwd_stash": 1,
        "fused_mlp_bwd": 1, "chain_mask_bits": 1}
    graph.replay()
    torch.cuda.synchronize()
    for name in eager:
        assert torch.equal(grads[name], eager[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [(256, torch.float32),
                                          (600, torch.bfloat16)])
def test_the_float32_and_wide_plans_count_no_mask_bits(device, hidden, dtype):
    gen = torch.Generator().manual_seed(hidden)
    net = DepthMipMLP(hidden_size=hidden, compute_dtype=dtype,
                      generator=gen).to(device)
    rays, k = 20, 13
    ipe = (torch.rand(rays * k, 96, generator=gen) * 2 - 1).to(device)
    dirs = (torch.rand(rays, 27, generator=gen) * 2 - 1).to(device)
    g = torch.randn(rays * k, 6, generator=gen).to(device)
    before = fk.LAUNCHES["chain_mask_bits"]
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, k, stash=True)
    fk.fused_mlp_backward(net, ipe, dirs, g, k, stash)
    torch.cuda.synchronize()
    assert stash.bits is None
    assert fk.LAUNCHES["chain_mask_bits"] == before


@pytest.mark.cuda
def test_the_backward_refuses_a_stash_without_its_words(device):
    net, ipe, dirs, g = _case(MipMLP, 128, 10, 7, 1, device)
    _, stash = fk.fused_mlp_forward(net, ipe, dirs, 7, stash=True)
    before = dict(fk.LAUNCHES)
    for bad in (None, stash.bits[:-1], stash.bits.float()):
        with pytest.raises(ValueError, match="mask bits"):
            fk.fused_mlp_backward(net, ipe, dirs, g, 7,
                                  stash._replace(bits=bad))
    assert fk.LAUNCHES == before
