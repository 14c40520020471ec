"""The SASS census's parser (``tools/sass_census.py`` of the port) on the CPU.

The census runs ``cuobjdump -sass`` on the card's libraries; here its
parser, loop finder and classes run on a committed excerpt in
``cuobjdump -sass``'s format (``tests/data/sass_census_excerpt.txt``): two
small functions written for the loop rules (a render kernel with a loop
that stores around a store-free one, a shorter loop, a call to a slow path
and the closing self-branch; a gradient kernel whose first loop comes
before the shared-memory ones), and 26 instructions cut from the flagship
render kernel's march loop as the card compiled it (the renormalization
cadence's integer modulo among them).
"""

from pathlib import Path

import pytest

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
