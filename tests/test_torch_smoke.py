"""``chip_smoke.py``'s reading of the ptxas report, on the CPU.

The smoke itself needs the card; its build phase holds every Hopper kernel
to zero spills by the names this parser gives them, so a template argument
that the parser dropped or garbled would let a kernel escape the check.
The mangled names are the ones nvcc 12.9 gives the port's kernels.
"""

import pytest

import chip_smoke

REPORT = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    16 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 16 bytes cumulative stack size
"""

GATED = "_ZN40_GLOBAL__N__a4712fb8_8_gated_cu_ed8bba29"


@pytest.mark.parametrize("mangled,name", [
    (GATED + "13wg_bwd_kernelILi1ELb1EEEvNS_6WgBwdPE", "wg_bwd_kernel<1, true>"),
    (GATED + "13wg_bwd_kernelILi2ELb0EEEvNS_6WgBwdPE", "wg_bwd_kernel<2, false>"),
    (GATED + "13wg_fwd_kernelILi1EEEvNS_6WgFwdPE", "wg_fwd_kernel<1>"),
    (GATED + "12wg_dw_kernelENS_5WgDwPE", "wg_dw_kernel"),
    (GATED + "19gated_reduce_kernelEPKfPfix", "gated_reduce_kernel"),
    ("_ZN43_GLOBAL__N__b731e597_10_fastgen_cu_cd6989dc14fastgen_kernelILi2EEEvNS_6ParamsE",
     "fastgen_kernel<2>"),
    ("_ZN37_GLOBAL__N__357a87a4_5_vq_cu_fd27733f9vq_kernelILi8ELb1EEEvPKfS2_iiiiPiPfS4_S4_Pj",
     "vq_kernel<8, true>"),
])
def test_ptxas_report_names_each_kernel_with_its_template_arguments(mangled, name):
    assert chip_smoke.ptxas_kernels(REPORT.format(name=mangled)) == {
        name: (168, 20, 24, 16)}


def test_ptxas_report_keeps_every_instance_apart():
    """The three backward instances (saved y, pair, recompute mode) stay
    three entries, each with its own numbers."""
    names = [GATED + f"13wg_bwd_kernelILi{nl}ELb{rec}EEEvNS_6WgBwdPE"
             for nl, rec in ((1, 0), (2, 0), (1, 1))]
    got = chip_smoke.ptxas_kernels("".join(REPORT.format(name=n) for n in names))
    assert sorted(got) == ["wg_bwd_kernel<1, false>", "wg_bwd_kernel<1, true>",
                           "wg_bwd_kernel<2, false>"]
    assert set(chip_smoke.HOPPER_KERNELS) >= set(got)
