"""The float64 AB3 march's census (``tools/march_census.py`` of the port) on
the CPU: the text edits it builds its copies of ``csrc/march.cu`` from,
and its reading of ``cuobjdump`` and ptxas output. The launches and the
builds run on the card only.
"""

from pathlib import Path

import pytest

from blackhole_simulation_tpu_torch.tools import march_census as mc

MARCH_CU = Path(mc.CSRC) / "march.cu"


def test_count_lanes_counts_each_pass_of_the_step_loop():
    text = MARCH_CU.read_text()
    out = mc.count_lanes(text)
    assert out.count("++n_rep;") == 1
    # the sum and the largest count over the warp after each pass, added to
    # the ray pool's words 2..5 once per warp
    assert out.count("__reduce_add_sync(FULL_MASK, n_rep)") == 1
    assert out.count("__reduce_max_sync(FULL_MASK, n_rep)") == 1
    assert out.index("++n_rep;") < out.index("__reduce_add_sync")
    assert out.index("pool + 4") < out.index("  pool_retire(pool);")
    with pytest.raises(RuntimeError):
        mc.count_lanes(text.replace("  int j = -1;", "  int j = -2;"))


def test_capped_caps_the_float64_kernels():
    out = mc.capped(4)(MARCH_CU.read_text())
    assert "__launch_bounds__(THREADS, 4)\nmarch_kernel_f64(" in out
    assert out.count("__launch_bounds__(THREADS, 4)") == 1
    assert mc.capped(4)("march_kernel(") == "march_kernel("


SASS = """\
\tcode for sm_90a
\t\tFunction : _Z16march_kernel_f64ILi1EEvPKdS1_
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   DADD R2, R2, R4 ;   /* 0x0000000402027229 */
        /*0010*/                   EXIT ;              /* 0x000000000000794d */

\t\tFunction : _Z12march_kernelILi0ELb1EEvPKfS1_
        /*0000*/                   FADD R2, R2, R4 ;   /* 0x0000000402027221 */
"""


def test_functions_keeps_each_kernel_s_lines():
    out = mc.functions(SASS)
    assert list(out) == ["march_kernel_f64<1>", "march_kernel<0,1>"]
    assert out["march_kernel_f64<1>"].splitlines()[1] == (
        "/*0000*/ DADD R2, R2, R4 ; /* 0x0000000402027229 */")
    assert len(out["march_kernel_f64<1>"].splitlines()) == 3
    assert mc.first_differences(out["march_kernel_f64<1>"],
                                out["march_kernel_f64<1>"]) == [3, 3, []]
    n_a, n_b, diffs = mc.first_differences("a\nb\nc", "a\nx\nc\nd")
    assert (n_a, n_b, diffs) == (3, 4, [[1, "b", "x"]])
    # the encodings' column, padded to the widest instruction of a dump,
    # does not part two functions; an encoding does
    wide = SASS.replace("R4 ;   /*", "R4 ;      /*")
    assert mc.functions(wide) == out
    assert mc.functions(SASS.replace("0x0000000402027229",
                                     "0x0000000402027228")) != out


def test_lmem_warnings():
    report = ("ptxas info    : Compiling entry function 'k' for 'sm_90a'\n"
              "ptxas warning : Local memory used for function 'k', size of "
              "stack frame: 96 bytes\n"
              "march.cu(12): warning #128-D: loop is not reachable\n")
    assert mc.lmem_warnings(report) == [
        "ptxas warning : Local memory used for function 'k', size of stack "
        "frame: 96 bytes"]


def test_the_census_marches_phase_23_s_rays():
    cfg = mc.AB3_CFG
    assert cfg.multistep and not cfg.approx_recip and not cfg.use_pallas
    assert (cfg.max_steps, cfg.step_rate, cfg.midpoint_iters) == (256, 0.2, 1)
    assert cfg.shadow_precull and cfg.far_step_cap_rate == 0.4
    assert mc.AB3_LABEL == "march_kernel_f64<1>"
