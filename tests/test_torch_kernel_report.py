"""The compiler report's parsers (`slide_tpu_torch/kernel_report.py`) on
text in the formats of `ptxas -v` and `cuobjdump -sass`; the report itself
needs the CUDA toolkit."""

from slide_tpu_torch.kernel_report import _count_sass, _ptxas

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z6gemm_tILi2ELi4ELb1ELi8EEvv
    0 bytes stack frame, 136 bytes spill stores, 284 bytes spill loads
ptxas info    : Compiling entry function '_Z3k1vPf' for 'sm_90a'
ptxas info    : Function properties for _Z3k1vPf
    400 bytes stack frame, 408 bytes spill stores, 220 bytes spill loads
ptxas info    : Used 168 registers, used 2 barriers, 400 bytes cumulative stack size
"""

SASS = """\
        code for sm_90a
                Function : _Z3k1vPf
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.1688.F32.TF32 R24, R4, R12, R24 ;
        /*0020*/              @!P0 LDL.64 R2, [R1+0x10] ;
        /*0030*/                   FADD R5, R5, R6 ;
                Function : _Z6gemm_tILi2ELi4ELb1ELi8EEvv
        /*0000*/               @P1 STL [R1+0x4], R7 ;
        /*0010*/                   HMMA.1688.F32.TF32 R8, R4, R12, RZ ;
        /*0020*/                   HMMA.1688.F32.TF32 R8, R6, R14, R8 ;
        /*0030*/                   RET.REL.NODEC R20 0x0 ;
"""


def test_ptxas_figures_per_function():
    got = _ptxas(PTXAS)
    assert got == {
        "_Z6gemm_tILi2ELi4ELb1ELi8EEvv": {"stack": 0, "spill_stores": 136, "spill_loads": 284},
        "_Z3k1vPf": {"stack": 400, "spill_stores": 408, "spill_loads": 220, "regs": 168}}


def test_sass_counts_per_function():
    got = _count_sass(SASS)
    k1, gemm = got["_Z3k1vPf"], got["_Z6gemm_tILi2ELi4ELb1ELi8EEvv"]
    assert (k1["total"], k1["HMMA"], k1["LDL"], k1["FADD"], k1["STL"]) == (4, 1, 1, 1, 0)
    assert (gemm["total"], gemm["HMMA"], gemm["STL"], gemm["LDL"]) == (4, 2, 1, 0)
