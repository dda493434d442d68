"""The frozen roofline and MFU arithmetic against the numbers the port's
kernel table was read with."""

import pytest

from portbench import counts


def test_macs_a_row_at_256():
    assert counts.row_macs(256, True) == 607_104
    assert counts.row_macs(512, True) == 2_262_144


def test_bounds_at_the_kernel_tables_shapes():
    b = counts.kernel_bounds(256, 524_288, 16_384, 65_536, 2_048, depth_head=True)
    assert round(b["fused_mlp_fwd"][0], 3) == 0.644 and b["fused_mlp_fwd"][1] == "operations"
    assert round(b["fused_mlp_fwd_stash"][0], 3) == 0.100
    assert b["fused_mlp_fwd_stash"][1] == "bytes"
    assert round(b["fused_mlp_bwd"][0], 3) == 0.154 and b["fused_mlp_bwd"][1] == "operations"


@pytest.mark.parametrize("nets", [[(256, True), (256, False)], [(256, False)] * 2])
def test_step_and_frame_work_add_up_per_launch(nets):
    flop, ms = counts.train_step_work(nets, 2048, (32, 32))
    fwd = sum(counts.forward_flop(h, d, 65_536, 2048) for h, d in nets)
    bwd = sum(counts.backward_flop(h, d, 65_536, 2048) for h, d in nets)
    assert flop == fwd + bwd
    assert ms == pytest.approx(sum(
        counts.kernel_bounds(h, 65_536, 2048, 65_536, 2048, d)[k][0]
        for h, d in nets for k in ("fused_mlp_fwd_stash", "fused_mlp_bwd")))
    flop, ms = counts.frame_work(nets, 800 * 800, 16_384, (32, 32))
    assert flop == pytest.approx(sum(counts.forward_flop(h, d, 640_000 * 32, 640_000)
                                     for h, d in nets))
    assert ms > 39 * sum(counts.kernel_bounds(h, 524_288, 16_384, 1, 1, d)["fused_mlp_fwd"][0]
                         for h, d in nets)
