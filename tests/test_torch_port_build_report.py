"""The build report of the port's CUDA kernels: ``kernels/build.py::
ptxas_report`` reads registers, spill bytes and advisories per kernel out of
an ``nvcc -Xptxas -v`` log.  ``chip_smoke.py`` fails a build on what it
reports, so the parser is held to the log's format here, on text in the
shape ptxas 12.9 prints for sm_90a (no compiler is needed)."""

import pytest

from ddnerf_tpu_torch.kernels import build

CHAIN = ("_ZN49_GLOBAL__N__a0c89a0f_16_fused_mlp_bwd_cu_1b338ba012chain_kernel"
         "ILi256EEEvNS_11ChainParamsENS_9ChainMapsE")
FWD64 = ("_ZN49_GLOBAL__N__3b59d819_16_fused_mlp_fwd_cu_8a80d7f220fused_mlp_fwd"
         "_kernelILi64ELb1EEEvNS_6ParamsENS_10TensorMapsE")
DPROJ = ("_ZN49_GLOBAL__N__a0c89a0f_16_fused_mlp_bwd_cu_1b338ba017dproj_grad_"
         "kernelEPKfP13__nv_bfloat16i")

LOG = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async instructions are serialized due to program dependence on compiler-inserted WG.AR in divergent path in the function '{FWD64}
ptxas info    : Compiling entry function '{CHAIN}' for 'sm_90a'
ptxas info    : Function properties for {CHAIN}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers
ptxas info    : Compiling entry function '{FWD64}' for 'sm_90a'
ptxas info    : Function properties for {FWD64}
    32 bytes stack frame, 24 bytes spill stores, 40 bytes spill loads
ptxas info    : Used 167 registers, used 16 barriers, 32 bytes cumulative stack size
ptxas info    : Compiling entry function '{DPROJ}' for 'sm_90a'
ptxas info    : Function properties for {DPROJ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 0 barriers
nvcc warning : Support for offline compilation for architectures prior to '<compute/sm/lto>_75' will be removed in a future release.
"""


@pytest.mark.parametrize("mangled,name", [
    (CHAIN, "chain_kernel<256>"),
    (FWD64, "fused_mlp_fwd_kernel<64,1>"),
    (DPROJ, "dproj_grad_kernel"),
    ("not_a_mangled_name", "not_a_mangled_name"),
])
def test_kernel_name_reads_the_mangled_name(mangled, name):
    assert build.kernel_name(mangled) == name


def test_ptxas_report_reads_registers_spills_and_advisories():
    report = build.ptxas_report(LOG)
    assert [r.name for r in report] == [
        "chain_kernel<256>", "fused_mlp_fwd_kernel<64,1>", "dproj_grad_kernel"]
    chain, fwd, dproj = report
    assert (chain.registers, chain.spill_bytes, chain.advisories) == (168, 0, ())
    assert (fwd.registers, fwd.spill_bytes) == (167, 64)
    assert len(fwd.advisories) == 1 and fwd.advisories[0].startswith("(C7520)")
    assert (dproj.registers, dproj.spill_bytes, dproj.advisories) == (31, 0, ())


def test_ptxas_report_of_a_log_without_kernels_is_empty():
    assert build.ptxas_report("") == []
    assert build.ptxas_report("nvcc warning : nothing compiled\n") == []
