"""The tone-map kernel (``csrc/tonemap.cu``, ``ops/tonemap.py``) and the rule
by which ``render/post.py::tonemap`` takes it.

On the CPU: that the CPU and autograd take the plain path, whatever the
parameters, with no launch of ``tonemap_kernel``; the route
``torch.pow`` takes for each exponent (``pow_route``); and that the
wrapper refuses what the kernel does not take (``refusal``). On the card
(marked ``gpu``): the kernel against the plain path, bit for bit, in
float32 and float64, on the render's planar view and on a contiguous
image, at sizes past a tile and past the whole frame, with pixels at the
bloom threshold, negatives, zeros, infinities and NaNs; its parameters,
the special exponents and the chain of launches past two bloom passes;
autograd keeping the plain path; the refusals raising; one launch a frame.

This file imports neither JAX nor the JAX package; its card tests run on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_tonemap_kernel.py
"""

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu_torch.ops import tonemap as ops
from blackhole_simulation_tpu_torch.ops.tonemap import (
    pow_route,
    refusal,
    tonemap_kernel,
    tonemap_kernel_shape,
)
from blackhole_simulation_tpu_torch.perf import spans
from blackhole_simulation_tpu_torch.render import (
    Camera,
    MarchConfig,
    PostParams,
    Scene,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    render,
    render_sample,
)
from blackhole_simulation_tpu_torch.render.post import (
    _differentiated,
    tonemap,
    tonemap_plain,
)

torch.set_num_threads(1)

FLAGSHIP_POST = PostParams(exposure=1.2)
# Width x height: the 1080p frame, the live loop's 1280x704 rung, and
# frames narrower or shorter than a tile and than the 8-pixel halo.
SIZES = [(1920, 1080), (1280, 704), (33, 1), (7, 5), (3, 17)]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _image(width, height, dtype=torch.float32, planar=True, device="cpu",
           seed=0, planted=True):
    """A seeded (H, W, 3) radiance image, uniform in [-0.2, 3], with planted
    values (unless ``planted`` is false): at and around the bloom threshold
    of the flagship's exposure, negatives, signed zeros, infinities and
    NaNs. ``planar``: the render's view of a (3, H, W) buffer, else a
    contiguous (H, W, 3) tensor."""
    rng = np.random.default_rng(seed + 7919 * width + height)
    x = rng.uniform(-0.2, 3.0, (height, width, 3))
    flat = x.reshape(-1)
    thr = 0.85
    values = [0.0, -0.0, -1.0, np.inf, -np.inf, np.nan, thr, thr / 1.2,
              np.nextafter(thr, 0.0), np.nextafter(thr, 1.0), 1e30, -1e30]
    if planted:
        at = rng.choice(flat.size, size=min(flat.size, 3 * len(values)),
                        replace=False)
        flat[at] = np.resize(values, at.size)
    # whole pixels whose luma lands at the threshold
    n = x.shape[0] * x.shape[1]
    for i in rng.choice(n, size=min(n, 4), replace=False):
        x.reshape(-1, 3)[i] = thr
    t = torch.tensor(x, dtype=dtype)
    if planar:
        t = t.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    return t.to(device)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _assert_bit_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    same = _bits(got) == _bits(want)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} values differ; first at "
        f"{(~same).nonzero()[0].tolist()}")


def _scene(post=PostParams(bloom_passes=1), width=16, height=12):
    cam = Camera.create(r=30.0, theta=1.3, fov=0.5, width=width,
                        height=height)
    cfg = MarchConfig(max_steps=24, use_pallas=True, fused=True,
                      shadow_precull=True)
    return Scene.create(mass=1.0, spin=0.9, camera=cam, march_cfg=cfg,
                        post=post)


# ---- the dispatch rule, on the CPU ------------------------------------

def test_cpu_image_takes_the_plain_path():
    img = _image(9, 7)
    before = tonemap_kernel.launches
    _assert_bit_equal(tonemap(img, FLAGSHIP_POST),
                      tonemap_plain(img, FLAGSHIP_POST))
    assert "CUDA" in refusal(img, FLAGSHIP_POST)
    assert tonemap_kernel.launches == before


def test_recorded_cpu_frame_counts_no_kernel():
    """A frame recorded on the CPU records its spans as before and launches
    no ``tonemap_kernel``."""
    before = tonemap_kernel.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        render(_scene(), n_samples=2, device="cpu")
    assert [s.name for s in spans.recorded()].count("frame") == 1
    assert tonemap_kernel.launches == before


@pytest.mark.parametrize("make, params, word", [
    (lambda: _image(6, 5).requires_grad_(), FLAGSHIP_POST, "autograd"),
    (lambda: _image(6, 5), PostParams(bloom_passes=3), "CUDA"),
    (lambda: _image(6, 5), PostParams(bloom_passes=-1), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=1.0), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=2.0), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=0.5), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=1.0 / 3.0), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=-1.0), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=-2.0), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=-0.5), "CUDA"),
    (lambda: _image(6, 5), PostParams(gamma=2.0 - 2.0 ** -40), "CUDA"),
    (lambda: _image(6, 5).half(), FLAGSHIP_POST, "float16"),
    (lambda: _image(6, 5)[..., :2], FLAGSHIP_POST, "(H, W, 3)"),
    (lambda: _image(6, 5).reshape(-1, 3), FLAGSHIP_POST, "(H, W, 3)"),
    (lambda: _image(6, 5)[:0], FLAGSHIP_POST, "CUDA"),
    (lambda: _image(6, 5), PostParams(exposure=torch.tensor(1.2)),
     "Python numbers"),
], ids=["autograd", "passes3", "passes-1", "gamma1", "gamma2", "gamma0.5",
        "gamma1/3", "gamma-1", "gamma-2", "gamma-0.5", "gamma2-ulp",
        "float16", "channels2", "rows", "empty", "tensor-exposure"])
def test_plain_path_and_its_reason(make, params, word):
    """A CPU image takes ``tonemap_plain`` whatever its parameters, with
    no launch and no count; the kernel's wrapper would refuse it, for the
    reason named (the parameters and autograd before the device, so that
    each shows on the CPU)."""
    img = make()
    assert word in refusal(img, params)
    before = tonemap_kernel.launches
    if (img.dtype in (torch.float32, torch.float64) and img.dim() == 3
            and img.shape[2] == 3):
        got, want = tonemap(img, params), tonemap_plain(img, params)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert tonemap_kernel.launches == before


def test_bloom_passes_do_not_matter_without_bloom():
    """With the bloom off, its pass count is not read: a CPU image is
    turned away for its device alone, and the kernel blurs nothing."""
    params = PostParams(bloom_enabled=False, bloom_passes=2.5)
    assert "CUDA" in refusal(_image(6, 5), params)
    assert ops._c_args(params, torch.float32).passes == 0
    assert "whole number" in refusal(_image(6, 5), PostParams(
        bloom_passes=2.5))


@pytest.mark.parametrize("passes, want", [(-3, 0), (0, 0), (2, 2), (7, 7)])
def test_kernel_bloom_passes(passes, want):
    """Negative bloom passes blur nothing, as ``range`` runs none; past
    ``FUSED_PASSES`` the wrapper asks for the chain's scratch."""
    assert ops._c_args(PostParams(bloom_passes=passes),
                       torch.float64).passes == want


def test_autograd_through_tonemap_keeps_its_gradient():
    img = _image(6, 5, planar=False, planted=False).requires_grad_()
    tonemap(img, FLAGSHIP_POST).sum().backward()
    ref = img.detach().clone().requires_grad_()
    tonemap_plain(ref, FLAGSHIP_POST).sum().backward()
    assert torch.equal(img.grad, ref.grad)
    with torch.no_grad():
        assert "CUDA" in refusal(img, FLAGSHIP_POST)


def test_differentiated_reads_image_and_parameters():
    """Autograd keeps the plain path where the image or a parameter needs a
    gradient, and only while gradients are enabled."""
    img = _image(6, 5)
    exposure = torch.tensor(1.2, requires_grad=True)
    assert not _differentiated(img, FLAGSHIP_POST)
    assert _differentiated(img, PostParams(exposure=exposure))
    assert _differentiated(img.requires_grad_(), FLAGSHIP_POST)
    with torch.no_grad():
        assert not _differentiated(img, PostParams(exposure=exposure))


@pytest.mark.parametrize("p, dtype, want", [
    (1 / 2.2, torch.float32, ops.POW), (1 / 2.2, torch.float64, ops.POW),
    (0.5, torch.float32, ops.SQRT), (1.0, torch.float64, ops.COPY),
    (0.0, torch.float32, ops.FILL_ONE), (3.0, torch.float64, ops.CUBE),
    (2.0 + 2.0 ** -30, torch.float32, ops.SQUARE),
    (2.0 + 2.0 ** -30, torch.float64, ops.POW),
    (-2.0, torch.float32, ops.INV_SQUARE), (0.25, torch.float32, ops.POW),
    (-0.5, torch.float64, ops.RSQRT), (-1.0, torch.float32, ops.RECIPROCAL),
    # sqrt, rsqrt, the reciprocal, the fill and the copy compare p itself
    (0.5 + 2.0 ** -40, torch.float32, ops.POW),
    (1.0 + 2.0 ** -40, torch.float32, ops.POW),
    (-3.0, torch.float64, ops.POW),
])
def test_special_exponent(p, dtype, want):
    assert pow_route(p, dtype) == want


@pytest.mark.parametrize("make, params, word", [
    (lambda: _image(6, 5), FLAGSHIP_POST, "CUDA"),
    (lambda: _image(6, 5).half(), FLAGSHIP_POST, "float16"),
    (lambda: _image(6, 5).to(torch.int32), FLAGSHIP_POST, "int32"),
    (lambda: torch.zeros(5, 6, 4), FLAGSHIP_POST, "(H, W, 3)"),
    (lambda: torch.zeros(5, 6, 3, 1), FLAGSHIP_POST, "(H, W, 3)"),
    (lambda: _image(6, 5), PostParams(bloom_passes=3.0), "whole number"),
    (lambda: _image(6, 5), PostParams(gamma=torch.tensor(0.5)),
     "Python numbers"),
], ids=["device", "float16", "int32", "channels4", "rank4", "passes3",
        "gamma0.5"])
def test_wrapper_refuses_what_the_kernel_does_not_take(make, params, word):
    before = tonemap_kernel.launches
    with pytest.raises(ValueError, match="tone-map kernel") as err:
        tonemap_kernel(make(), params)
    assert word in str(err.value)
    assert tonemap_kernel.launches == before


# ---- the kernel on the card ---------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("planar", [True, False], ids=["planar", "contiguous"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_kernel_is_bit_equal_to_the_plain_path(cuda, size, dtype, planar):
    img = _image(*size, dtype=dtype, planar=planar, device=cuda)
    before = tonemap_kernel.launches
    got = tonemap(img, FLAGSHIP_POST)
    assert tonemap_kernel.launches == before + 1
    assert got.is_contiguous()
    _assert_bit_equal(got, tonemap_plain(img, FLAGSHIP_POST))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("params", [
    PostParams(bloom_enabled=False), PostParams(tonemap=False),
    PostParams(bloom_passes=1), PostParams(bloom_passes=0),
    PostParams(exposure=0.7, bloom_threshold=0.3, bloom_strength=1.3,
               gamma=1.8),
    PostParams(bloom_passes=3), PostParams(bloom_passes=4, tonemap=False),
    PostParams(bloom_passes=5), PostParams(bloom_passes=-1),
], ids=["no-bloom", "no-aces", "passes1", "passes0", "other-numbers",
        "passes3", "passes4-no-aces", "passes5", "passes-1"])
def test_kernel_parameters_are_bit_equal(cuda, params, dtype):
    img = _image(250, 141, dtype=dtype, device=cuda)
    _assert_bit_equal(tonemap_kernel(img, params), tonemap_plain(img, params))


@pytest.mark.gpu
def test_autograd_on_the_card_keeps_the_plain_path(cuda):
    img = _image(40, 24, device=cuda, planted=False).requires_grad_()
    before = tonemap_kernel.launches
    tonemap(img, FLAGSHIP_POST).sum().backward()
    ref = img.detach().clone().requires_grad_()
    tonemap_plain(ref, FLAGSHIP_POST).sum().backward()
    assert tonemap_kernel.launches == before
    assert torch.equal(img.grad, ref.grad)
    with torch.no_grad():                      # no derivative asked: kernel
        tonemap(img, FLAGSHIP_POST)
    assert tonemap_kernel.launches == before + 1


@pytest.mark.gpu
def test_image_taller_than_a_grid_dimension(cuda):
    """More tile rows than a launch's second grid dimension holds (65,535):
    the tiles are one row-major list."""
    img = _image(2, 1_100_000, device=cuda)
    _assert_bit_equal(tonemap_kernel(img, FLAGSHIP_POST),
                      tonemap_plain(img, FLAGSHIP_POST))


# 1 / gamma on each of torch.pow's routes, and beside them
GAMMAS = [1.0, 2.0, 0.5, 1.0 / 3.0, -1.0, -2.0, -0.5, float("inf"),
          2.0 - 2.0 ** -40, 2.0 + 2.0 ** -40, 1.0 - 2.0 ** -40]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("gamma", GAMMAS, ids=[repr(g) for g in GAMMAS])
def test_special_exponents_take_the_kernel(cuda, gamma, dtype):
    """Every exponent, those ``torch.pow`` special-cases included, takes
    the kernel and its bits."""
    img = _image(40, 24, dtype=dtype, device=cuda)
    params = PostParams(gamma=gamma)
    before = tonemap_kernel.launches
    _assert_bit_equal(tonemap(img, params), tonemap_plain(img, params))
    assert tonemap_kernel.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("size", [(7, 5), (3, 17), (33, 1)],
                         ids=["7x5", "3x17", "33x1"])
def test_chain_past_the_whole_frame(cuda, size):
    """Three bloom passes' chain on frames smaller than its halo."""
    img = _image(*size, device=cuda)
    params = PostParams(bloom_passes=3)
    _assert_bit_equal(tonemap(img, params), tonemap_plain(img, params))


@pytest.mark.gpu
@pytest.mark.parametrize("make, params, word", [
    (lambda d: _image(6, 5, device=d).half(), FLAGSHIP_POST, "float16"),
    (lambda d: _image(6, 5, device=d),
     PostParams(exposure=torch.tensor(1.2)), "Python numbers"),
    (lambda d: _image(6, 5, device=d)[..., :2], FLAGSHIP_POST, "(H, W, 3)"),
], ids=["float16", "tensor-exposure", "channels2"])
def test_cuda_refusals_raise(cuda, make, params, word):
    """On the card ``tonemap`` raises on what the kernel does not take;
    it never gives way to the plain path."""
    before = tonemap_kernel.launches
    with pytest.raises(ValueError, match="tone-map kernel") as err:
        tonemap(make(cuda), params)
    assert word in str(err.value)
    assert tonemap_kernel.launches == before


@pytest.mark.gpu
def test_parameter_under_autograd_keeps_the_plain_path(cuda):
    img = _image(40, 24, device=cuda, planted=False)
    exposure = torch.tensor(1.2, device=cuda, requires_grad=True)
    before = tonemap_kernel.launches
    tonemap(img, PostParams(exposure=exposure)).sum().backward()
    assert tonemap_kernel.launches == before
    assert exposure.grad is not None and bool(torch.isfinite(exposure.grad))


@pytest.mark.gpu
def test_empty_image_launches_nothing(cuda):
    img = _image(6, 5, device=cuda)[:0]
    before = tonemap_kernel.launches
    assert tonemap(img, FLAGSHIP_POST).shape == (0, 6, 3)
    assert tonemap_kernel.launches == before


@pytest.mark.gpu
def test_kernel_leaves_its_input_and_sees_late_writes(cuda):
    """The kernel reads its input on the stream, after earlier writes, and
    leaves it unchanged."""
    img = _image(64, 48, device=cuda)
    keep = img.clone()
    img.mul_(1.5)
    got = tonemap_kernel(img, FLAGSHIP_POST)
    _assert_bit_equal(got, tonemap_plain(keep * 1.5, FLAGSHIP_POST))
    assert torch.equal(img.nan_to_num(), (keep * 1.5).nan_to_num())


@pytest.mark.gpu
def test_render_frame_launches_the_kernel_once(cuda):
    """A recorded fused frame launches ``tonemap_kernel`` once and counts
    its one sync, and its image is the plain tone map of its radiance."""
    scene = _scene(FLAGSHIP_POST, width=64, height=48)
    render(scene, n_samples=1, device=cuda)
    torch.cuda.synchronize()
    before = tonemap_kernel.launches
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        img = render(scene, n_samples=1, device=cuda)
    assert tonemap_kernel.launches == before + 1
    assert spans.counters().get("stream_syncs") == 1
    planes = render_sample(scene, None, cuda)
    _assert_bit_equal(img, tonemap_plain(planes.permute(1, 2, 0), scene.post))


@pytest.mark.gpu
def test_kernel_shape(cuda):
    for dtype in DTYPES:
        for params in (FLAGSHIP_POST, PostParams(bloom_passes=3)):
            shape = tonemap_kernel_shape(params, dtype)
            assert shape["blocks_per_sm"] >= 1 and shape["sms"] >= 1
            assert shape["smem_bytes"] > 0 and shape["threads"] % 32 == 0
