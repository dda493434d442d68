"""The trace arithmetic on made-up traces: busy time is a union, so
overlapping activities count once; gaps are labelled by the benchmark's
spans; the MLP kernels are picked out by name."""

import pytest

from portbench import harness, layer, tracing
from portbench.tracing import Interval


def test_union_counts_overlap_once():
    assert tracing.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert tracing.union_seconds([]) == 0.0


def test_gaps_inside_a_window():
    assert tracing.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [(0, 1), (3, 5), (6, 7)]


@pytest.mark.parametrize("name,mlp", [
    ("void (anonymous namespace)::chain_kernel<256>((anonymous namespace)::ChainParams)", True),
    ("void (anonymous namespace)::fused_mlp_fwd_kernel<256, false>(Params)", True),
    ("void (anonymous namespace)::wgrad_kernel<4>(WParams, WMaps)", True),
    ("void (anonymous namespace)::reduce_kernel(RParams)", True),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)", False),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int, float)", False),
    ("Memcpy DtoH (Device -> Pinned)", False),
])
def test_mlp_kernels_by_name(name, mlp):
    assert tracing.is_mlp_kernel(name) is mlp


def _made_up():
    host = [Interval(tracing.STRETCH, 0.0, 10.0),
            Interval("portbench.replay_block", 0.0, 6.0),
            Interval("cudaGraphLaunch", 0.5, 5.0),
            Interval("portbench.read_back", 6.0, 10.0),
            Interval("aten::copy_", 6.5, 9.5)]
    dev = [Interval("void (anonymous namespace)::chain_kernel<256>(P)", 1.0, 3.0),
           Interval("void at::native::elementwise_kernel<128>(f)", 2.0, 4.0),
           Interval("void at::native::elementwise_kernel<128>(f)", 4.5, 5.0),
           Interval("Memcpy DtoH", 9.0, 9.5),
           Interval("after the stretch", 11.0, 12.0)]
    return dev, host


def test_digest_of_a_made_up_stretch():
    d = tracing.digest(*_made_up())
    assert d.window_s == 10.0
    assert d.busy_s == pytest.approx(3.0 + 0.5 + 0.5)
    assert d.mlp_s == pytest.approx(2.0)
    assert d.other_s == pytest.approx(2.0)
    assert d.top_ops[0] == ("void at::native::elementwise_kernel<128>(f)", 2.5)
    longest = d.idle_gaps[0]
    assert longest == ("portbench.read_back / aten::copy_", pytest.approx(4.0))
    assert ("portbench.replay_block / cudaGraphLaunch", pytest.approx(0.5)) in d.idle_gaps
    assert tracing.digest(_made_up()[0], []) is None


def test_layer_readers_on_a_run():
    d = tracing.digest(*_made_up())
    run = harness.LayerRun("train", items=100, window_s=10.0, flop_per_item=1e11,
                           bound_ms_per_item=1.0, trace=d, traced_items=2)
    # 4 s busy of the stretch's 10 s wall
    assert layer.idle_share(run, "train") == pytest.approx(60.0)
    assert layer.mlp_roofline(run, "train") == pytest.approx(100 * 2e-3 / 2.0)
    assert layer.other_device_ms(run, "train") == pytest.approx(1e3)
    assert layer.mfu(run, "train") == pytest.approx(100 * 1e13 / 10 / 989e12)
    assert layer.mfu(run, "render") is None and layer.idle_share(run, "render") is None
    untraced = harness.LayerRun("train", 100, 10.0, 1e11, 1.0)
    assert layer.mlp_roofline(untraced, "train") is None


@pytest.mark.parametrize("device", [
    [],  # nothing ran in the stretch
    [Interval("k", -5.0, 15.0)],  # one activity over all of it
    [Interval("k", -1.0, 4.0), Interval("k", 3.0, 9.0), Interval("k", 8.0, 12.0)],
    [Interval("k", 1.0, 2.0)] * 50,  # one interval, counted fifty times by a sum
    [Interval("k", 0.1 * i, 0.1 * i + 0.3) for i in range(100)],
])
def test_the_idle_share_lies_between_0_and_100(device):
    host = [Interval(tracing.STRETCH, 0.0, 10.0)]
    d = tracing.digest(device, host)
    run = harness.LayerRun("train", items=1, window_s=0.01, flop_per_item=1.0,
                           bound_ms_per_item=1.0, trace=d, traced_items=1)
    share = layer.idle_share(run, "train")
    assert 0.0 <= share <= 100.0
    assert share == pytest.approx(100 * (1 - d.busy_s / 10.0))
