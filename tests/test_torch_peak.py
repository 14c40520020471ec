"""The FP32 peak probe (``tools/vpu_peak.py`` of the port, kernel
``csrc/vpu_peak.cu``) on the CPU.

The JAX package's probe (``tools/vpu_peak.py``) defines its Pallas kernel
inside ``main()`` and cannot be called on its own, so the plain version is
held against the same recurrence with the tool's constants (k = 1.0000001,
b = 1e-7, as float32), each step x * k + b rounded once to float32 as a
fused multiply-add rounds it: in numpy, and in exact rational arithmetic.
They must agree bit for bit. The kernel itself runs only on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 1).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu_torch.tools import vpu_peak

torch.set_num_threads(1)

K32, B32 = np.float32(1.0000001), np.float32(1e-7)


def _numpy_chains(x, iters, unroll):
    for _ in range(iters * unroll):
        x = (x.astype(np.float64) * np.float64(K32)
             + np.float64(B32)).astype(np.float32)
    acc = x[0]
    for row in x[1:]:
        acc = acc + row
    return acc


@pytest.mark.parametrize("chains,iters,unroll", [(1, 16, 8), (8, 64, 4),
                                                 (16, 8, 16)])
def test_plain_version_matches_numpy(chains, iters, unroll):
    x = np.random.default_rng(chains).uniform(
        0.5, 2.0, (chains, 257)).astype(np.float32)
    out = vpu_peak.fma_chains_plain(torch.from_numpy(x), iters, unroll)
    np.testing.assert_array_equal(out.numpy(), _numpy_chains(x, iters, unroll))
    assert out.dtype == torch.float32 and out.shape == (257,)


def test_plain_version_rounds_each_step_once():
    """Each step equals x * k + b computed exactly and rounded once to
    float32 (the exact value is a double, so float() does not round it)."""
    x = np.random.default_rng(3).uniform(1.0, 2.0, 64).astype(np.float32)
    k, b = Fraction(float(K32)), Fraction(float(B32))
    ref = x.copy()
    for _ in range(96):
        exact = [Fraction(float(v)) * k + b for v in ref]
        assert all(Fraction(float(e)) == e for e in exact)
        ref = np.array([float(e) for e in exact]).astype(np.float32)
    out = vpu_peak.fma_chains_plain(torch.from_numpy(x[None]), 12, 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    # The unfused recurrence (two roundings per step) drifts from it.
    two = x.copy()
    for _ in range(96):
        two = two * K32 + B32
    assert not np.array_equal(two, ref)


def test_wrapper_runs_the_plain_version_for_cpu_tensors():
    x = torch.ones((8, 100))
    before = vpu_peak.fma_chains.launches
    out = vpu_peak.fma_chains(x, 4, 8)
    assert vpu_peak.fma_chains.launches == before   # no kernel launch
    assert torch.equal(out, vpu_peak.fma_chains_plain(x, 4, 8))
    with pytest.raises(ValueError):
        vpu_peak.fma_chains(x.double(), 4, 8)
    with pytest.raises(ValueError):
        vpu_peak.fma_chains(torch.ones((3, 100)), 4, 8)   # chains not built
    with pytest.raises(ValueError):
        vpu_peak.fma_chains(x, 4, 5)


def test_starts_are_seeded_and_in_range():
    a, b = (vpu_peak.starts(4, 1000, "cpu", seed=5) for _ in range(2))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= 1.0 and float(a.max()) < 2.0
    assert not torch.equal(a, vpu_peak.starts(4, 1000, "cpu", seed=6))


def test_measure_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vpu_peak.measure(iters=1, grid=1, reps=1)
