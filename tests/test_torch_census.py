"""The SASS census's parser (``tools/sass_census.py`` of the port) on the CPU.

The census runs ``cuobjdump -sass`` on the card's libraries; here its
parser, loop finder and classes run on a committed excerpt in
``cuobjdump -sass``'s format (``tests/data/sass_census_excerpt.txt``): two
small functions written for the loop rules (a render kernel with a loop
that stores around a store-free one, a shorter loop, a call to a slow path
and the closing self-branch; a gradient kernel whose first loop comes
before the shared-memory ones), and 26 instructions cut from the flagship
render kernel's march loop as the card compiled it (the renormalization
cadence's integer modulo among them). A march kernel written here in the
same format holds the rule of ``march.cu``'s kernels (a step loop that
reads and writes shared memory, as the float64 AB3 march's ring does) and
the local-memory counts; a ptxas report in ``-v``'s format holds
``ops/build.py``'s parser (registers, spill, stack frame).
"""

from pathlib import Path

import pytest

from blackhole_simulation_tpu_torch.ops import build
from blackhole_simulation_tpu_torch.tools import sass_census as sc

EXCERPT = Path(__file__).parent / "data" / "sass_census_excerpt.txt"
RENDER = "_Z13render_kernelILi0ELb0ELb1EEvPKfPfPiK12RenderStatic"
GRAD = ("_Z17march_grad_kernelILb1EEvPKfS0_S0_S0_S0_S0_S0_PfS1_S1_Piii"
        "11MarchParamsf")
REAL = "_Z13render_kernelILi0ELb0EEvPKfPfPiK12RenderStatic"


@pytest.fixture(scope="module")
def funcs():
    return sc.parse(EXCERPT.read_text())


def test_parse_reads_every_function_in_address_order(funcs):
    assert list(funcs) == [RENDER, GRAD, REAL]
    assert len(funcs[RENDER]) == 28 and len(funcs[GRAD]) == 14
    assert len(funcs[REAL]) == 26
    for instrs in funcs.values():
        addrs = [a for a, _ in instrs]
        assert addrs == sorted(addrs)
    assert funcs[RENDER][14] == (0xE0, "@!P1 BRA 0x30")
    assert funcs[REAL][0] == (0x4660, "IABS R2, R36")


def test_loops_are_the_back_edges(funcs):
    instrs = funcs[RENDER]
    spans = [(instrs[lo][0], instrs[hi][0]) for lo, hi in sc.loops(instrs)]
    # the store-free loop, the loop that stores around it, a short loop and
    # the closing self-branch; the forward CALL is no back-edge
    assert spans == [(0x30, 0xE0), (0x30, 0x100), (0x110, 0x130),
                     (0x150, 0x150)]


def test_march_loop_is_the_longest_outer_store_free_loop(funcs):
    instrs = funcs[RENDER]
    lo, hi = sc.march_loop(instrs)
    assert (instrs[lo][0], instrs[hi][0]) == (0x30, 0xE0)


def test_march_loop_with_shared_memory_is_the_first(funcs):
    instrs = funcs[GRAD]
    lo, hi = sc.march_loop(instrs)
    # the first loop, ahead of the shared-memory loop and the longer
    # store-free loop nested in it
    assert (instrs[lo][0], instrs[hi][0]) == (0x10, 0x30)


def test_census_counts_the_march_loop_by_class(funcs):
    out = sc.census(EXCERPT.read_text())
    assert set(out) == {"render_kernel<0,0,1>", "march_grad_kernel<1>"}
    r = out["render_kernel<0,0,1>"]
    assert r["loop"] == [0x30, 0xE0]
    assert r["total"] == 12
    expect = dict.fromkeys(sc.CLASSES, 0)
    expect.update(FMUL=1, FFMA=1, FADD=1, compare_select=3, MUFU=1, call=1,
                  integer=2, move=1, branch=1)
    assert r["counts"] == expect
    g = out["march_grad_kernel<1>"]
    assert g["loop"] == [0x10, 0x30] and g["total"] == 3
    assert g["counts"]["FMUL"] == g["counts"]["FADD"] == 1


def test_classes_of_compiled_instructions(funcs):
    counts = sc.count(funcs[REAL])
    expect = dict.fromkeys(sc.CLASSES, 0)
    expect.update(integer=14, convert=2, MUFU=1, FADD=2, FMUL=2, move=1,
                  compare_select=3, uniform=1)
    assert counts == expect
    # no back-edge in the cut: not a loop
    assert sc.march_loop(funcs[REAL]) is None


@pytest.mark.parametrize("op,cls", [
    ("FFMA", "FFMA"), ("FMUL.FTZ", "FMUL"), ("FADD.FTZ", "FADD"),
    ("FMNMX.NAN", "compare_select"), ("FSEL", "compare_select"),
    ("FCHK", "compare_select"), ("MUFU.RSQ", "MUFU"),
    ("IMAD.MOV.U32", "move"), ("IMAD.HI.U32", "integer"),
    ("HFMA2.MMA", "move"), ("DFMA", "double"), ("F2F.F64.F32", "convert"),
    ("BSSY", "branch"), ("CALL.REL.NOINC", "call"), ("LDG.E", "memory"),
    ("ULDC.64", "uniform"), ("NOP", "other"),
])
def test_classify(op, cls):
    assert sc.classify(op) == cls


def test_opcode_drops_the_predicate():
    assert sc.opcode("@!P2 IADD3 R33, R33, -R2, RZ") == "IADD3"
    assert sc.opcode("FSETP.NAN.OR P0, PT, R0, R0, !P0") == "FSETP.NAN.OR"


@pytest.mark.parametrize("mangled,label", [
    (RENDER, "render_kernel<0,0,1>"),
    ("_Z12march_kernelILi2ELb0EEvPKfS1_", "march_kernel<2,0>"),
    ("_Z17march_grad_kernelILb1EEvPKf", "march_grad_kernel<1>"),
    ("_Z19minmax_check_kernelPKfS0_Pfi", "minmax_check_kernel"),
    ("plain_name", "plain_name"),
])
def test_label(mangled, label):
    assert sc.label(mangled) == label


# A march kernel written for the loop rule of march.cu's kernels: an outer
# refill loop that takes rays (an atomic) and stores them, around a step
# loop that reads and writes its ring in shared memory and touches local
# memory, and after the body a slow-path subroutine with a short loop.
MARCH_F64 = "_Z16march_kernel_f64ILi1EEvPKdS1_"
MARCH_SASS = [
    (0x00, "S2R R0, SR_TID.X"),
    (0x10, "ATOMG.E.ADD.STRONG.GPU PT, R2, desc[UR4][R4.64], R3"),
    (0x20, "LDG.E.64 R8, desc[UR4][R6.64]"),
    (0x30, "DADD R10, R8, R8"),
    (0x40, "STS.64 [R12], R10"),
    (0x50, "STG.E.64 desc[UR4][R14.64], R10"),
    (0x60, "LDS.64 R16, [R12+0x400]"),
    (0x70, "LDS.64 R18, [R12+0x800]"),
    (0x80, "DFMA R20, R16, R18, R20"),
    (0x90, "STS.64 [R12+0xc00], R20"),
    (0xA0, "STL.64 [R1], R20"),
    (0xB0, "LDL.64 R22, [R1+0x8]"),
    (0xC0, "IADD3 R24, R24, 0x1, RZ"),
    (0xD0, "@P0 BRA 0x60"),
    (0xE0, "@P1 BRA 0x10"),
    (0xF0, "EXIT"),
    (0x100, "DMUL R30, R30, R30"),
    (0x110, "@P2 BRA 0x100"),
    (0x120, "RET.REL.NODEC R2 0x0"),
    (0x130, "BRA 0x130"),
]


def march_sass_text():
    lines = ["\tcode for sm_90a", f"\t\tFunction : {MARCH_F64}"]
    lines += [f"        /*{a:04x}*/                   {t} ;"
              for a, t in MARCH_SASS]
    return "\n".join(lines) + "\n"


def test_march_kernel_step_loop_may_use_shared_memory():
    instrs = sc.parse(march_sass_text())[MARCH_F64]
    assert instrs == MARCH_SASS
    lo, hi = sc.march_loop(instrs, march_kernel=True)
    assert (instrs[lo][0], instrs[hi][0]) == (0x60, 0xD0)
    # the rule of the other kernels would skip the ring's loop and take the
    # slow path's
    lo, hi = sc.march_loop(instrs)
    assert (instrs[lo][0], instrs[hi][0]) == (0x100, 0x110)


def test_census_of_a_march_kernel_counts_its_local_memory():
    out = sc.census(march_sass_text())
    rec = out["march_kernel_f64<1>"]
    assert rec["loop"] == [0x60, 0xD0] and rec["total"] == 8
    expect = dict.fromkeys(sc.CLASSES, 0)
    expect.update(memory=5, double=1, integer=1, branch=1)
    assert rec["counts"] == expect
    assert rec["local"] == {"LDL": 1, "STL": 1}


def test_local_count(funcs):
    assert sc.local_count(funcs[REAL]) == {"LDL": 0, "STL": 0}
    assert sc.local_count([(0, "@P0 STL.128 [R1+0x10], R4"),
                           (16, "LDL.64 R2, [R1]"),
                           (32, "LDL R3, [R1+0x8]")]) == {"LDL": 2, "STL": 1}
    out = sc.census(EXCERPT.read_text())
    assert out["render_kernel<0,0,1>"]["local"] == {"LDL": 0, "STL": 0}


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16march_kernel_f64ILi2EEvPKd' for 'sm_90a'
ptxas info    : Function properties for _Z16march_kernel_f64ILi2EEvPKd
    328 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 328 bytes cumulative stack size
ptxas info    : Compile time = 152.390 ms
ptxas info    : Function properties for __internal_accurate_pow
    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z16march_kernel_f64ILi1EEvPKd' for 'sm_90a'
ptxas info    : Function properties for _Z16march_kernel_f64ILi1EEvPKd
    8 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 18432 bytes smem
"""


def test_parse_ptxas_reads_registers_spill_and_stack_frame():
    assert build.parse_ptxas(PTXAS) == [
        ("_Z16march_kernel_f64ILi2EEvPKd", 96, 0, 328),
        ("_Z16march_kernel_f64ILi1EEvPKd", 96, 32, 8)]
