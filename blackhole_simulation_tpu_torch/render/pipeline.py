"""The render pipeline: scene -> supersampled, tone-mapped image.

Counterpart of ``blackhole_simulation_tpu/render/pipeline.py``: ``Features``
(:49), ``Scene`` (:87), ``ensure_spectral_coeffs`` (:131),
``halton_jitters`` (:181), ``shade_march_rows`` (:273),
``fused_path_active`` (:164), ``refine_critical_band`` (:333),
``render_sample`` (:406; its fused branch :434-451 and its staged branch
:452-518), ``render`` (:581, with the staged overlay of ``_render_jit``
:557-575), ``render_radiance`` (:600), and the oracle layer's entries:
``shade_sample_rows`` (:188) and ``shade_sample`` (:264), which shade in
the dtype they are given, ``render_sample_scaled`` (:520) and
``oracle_render`` (:608).

A sample takes one of two branches, as in the JAX package:

* fused (``use_pallas`` and ``fused``): one launch of the render kernel
  (``ops/render.py``, ``csrc/render.cu``) per Halton-jittered sample;
* staged (otherwise): rays from ``camera_rays_u`` (in pixel-block order when
  ``use_pallas`` and no jets, row-major otherwise), the NRS far-field skip
  (``models/nrs.nrs_far_field_rows``, without jets), the march kernel
  (``march_rows`` -> ``csrc/march.cu``, with the jets' emission in its
  loop) and the composite ``shade_march_rows`` in plain PyTorch on the
  device, then the NRS background of the far rays.

Every feature runs on both branches. Where the JAX package's two branches
differ, the port differs the same way: the fused kernel runs the NRS skip
with jets on too; with ``start_jitter`` its NRS background is born from the
offset u and phi but the camera's r, and its overlay reads the offset rays;
the overlay is in the fused ``render_radiance`` and only in the staged
``render``; refined pixels lose the fused overlay (ROADMAP Queue 3).

With ``MarchConfig.refine_band`` > 0 (the certified render), either branch
ends with the critical-band refinement pass: the pixels whose band metric
(the render kernel's fourth plane, or ``critical_band_metric_u`` of the
staged rays) is below ``refine_band`` are re-marched on the march kernel at
``refinement_config`` and overwrite the coarse ones.

Samples are accumulated and tone-mapped on the device. The entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, which selects the
kernels' plain PyTorch versions. With no CUDA device and no explicit CPU
request they raise; they never fall back to the CPU.

The render is differentiable, as the JAX package's is under ``jax.grad``:
the scene's data leaves (``bh.mass``, ``bh.spin``, the camera's r, theta,
phi, fov and roll, numbers or 0-d tensors, and the NRS weights) may
require grad, and ``render``, ``render_radiance`` and
``render_sample_scaled`` then carry their derivatives on the staged route
(``use_pallas=False``, the ``MarchConfig`` default): the camera's ray
birth, the NRS far field, the march (``march_rows``: the march kernel
forward and the gradient kernel backward, the jets' emission and the start
offset included), the composite with the spectral disk's tables built in
the graph, the refinement pass, the overlay and the tone map. Where the
JAX package raises (a fused scene, or ``use_pallas`` without jets, whose
Pallas kernels have no VJP) the port raises NotImplementedError. No cache
is keyed by a tensor leaf: the host reads their values (``_elementwise.
host``) for its static decisions and caches.

Every entry takes ``dtype`` (``torch.float32`` by default, or
``torch.float64``), as the JAX package's do, and follows its routes:

* staged (``use_pallas=False``): the render in ``dtype`` end to end, mass
  and spin unrounded in float64, the march on the march kernel's float64
  instantiation (its plain version on the CPU) and, under autograd, its
  gradient on the gradient kernel's;
* fused: the render kernel in float32 on a parameter row built from the
  float64 mass and spin, the camera tetrad and the radii in float64
  (``ops/render.build_param_row``), so the image is float32, as the JAX
  package's Pallas kernel returns it; ``render`` accumulates its samples
  in ``dtype`` (from zeros) where there are several, as JAX's scan does;
* staged with ``use_pallas`` and no jets: TypeError in float64, where the
  JAX package's Pallas march fails to trace (``march_rows``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch._elementwise import (
    grad_wanted,
    host,
    leaf,
)
from blackhole_simulation_tpu_torch.geometry.metrics import Kerr
from blackhole_simulation_tpu_torch.perf import spans
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import MarchConfig
from blackhole_simulation_tpu_torch.render.post import PostParams, tonemap
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams,
    JetParams,
    StarfieldParams,
    spectral_kernel_tables,
)


@dataclasses.dataclass(frozen=True)
class Features:
    """Feature toggles (static: they select kernel branches)."""

    disk: bool = True
    starfield: bool = True
    photon_ring_glow: bool = True
    jets: bool = False
    spectral_lut: bool = False
    shadow_overlay: bool = False
    nrs_far_field: bool = False

    def __post_init__(self):
        if self.jets and not self.disk:
            object.__setattr__(self, "jets", False)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Full scene description. ``spectral_coeffs``: host Chebyshev tables
    (t_coeffs (K,), rgb_coeffs (3, K), inv_logr) of the spectral disk, or
    None (then ``render`` builds them for a fused scene; a staged one
    shades from the LUTs)."""

    bh: Kerr
    camera: Camera
    disk: DiskParams = DiskParams()
    jet_params: JetParams = JetParams()
    stars: StarfieldParams = StarfieldParams()
    features: Features = Features()
    march_cfg: MarchConfig = MarchConfig()
    post: PostParams = PostParams()
    spectral_coeffs: tuple | None = None
    nrs_params: tuple | None = None

    @classmethod
    def create(cls, mass=1.0, spin=0.9, camera=None, **kw):
        f = lambda v: v if isinstance(v, torch.Tensor) else float(v)
        bh = Kerr(mass=f(mass), spin=f(spin))
        scene = cls(bh=bh, camera=camera or Camera.create(), **kw)
        return ensure_spectral_coeffs(scene)

    def leaves(self) -> list:
        """The scene's data leaves, the JAX ``Scene``'s pytree leaves: mass,
        spin, the camera's five fields and the NRS weights (numbers or
        tensors)."""
        cam = self.camera
        out = [self.bh.mass, self.bh.spin, cam.r, cam.theta, cam.phi,
               cam.fov, cam.roll]
        if self.nrs_params is not None:
            out += [t for w_b in self.nrs_params for t in w_b]
        return out


def scene_from_numpy(*, mass, spin, camera: dict, march_cfg: dict | None = None,
                     features: dict | None = None, disk: dict | None = None,
                     stars: dict | None = None, post: dict | None = None,
                     jet_params: dict | None = None,
                     spectral_coeffs=None, nrs_params=None,
                     device=None) -> Scene:
    """Build the port's Scene from a JAX Scene's leaves and static fields
    given as plain numbers and numpy arrays: ``mass`` and ``spin``; the
    camera's r/theta/phi/fov/roll/width/height; and each static dataclass
    (MarchConfig, Features, DiskParams, StarfieldParams, PostParams,
    JetParams) as a dict of its fields (``dataclasses.asdict``). The
    ``spectral_coeffs`` tables, if given, are used as they are;
    ``nrs_params``, the NRS weights as (w, b) arrays, go through
    ``models/nrs.nrs_params_from_numpy`` onto ``device`` (``cuda`` unless
    the caller passes ``"cpu"``; unused without weights)."""
    from blackhole_simulation_tpu_torch.models.nrs import (
        nrs_params_from_numpy,
    )

    def make(cls, fields):
        if fields is None:
            return cls()
        fields = dict(fields)
        if fields.get("artistic_rgb") is not None:
            fields["artistic_rgb"] = tuple(float(v) for v in fields["artistic_rgb"])
        return cls(**fields)

    cam = Camera.create(
        r=float(camera["r"]), theta=float(camera["theta"]),
        phi=float(camera["phi"]), fov=float(camera["fov"]),
        roll=float(camera["roll"]), width=int(camera["width"]),
        height=int(camera["height"]),
    )
    if spectral_coeffs is not None:
        tc, rc, il = spectral_coeffs
        spectral_coeffs = (np.asarray(tc, np.float32), np.asarray(rc, np.float32),
                           np.asarray(il, np.float32))
    scene = Scene(
        bh=Kerr(mass=float(mass), spin=float(spin)),
        camera=cam,
        disk=make(DiskParams, disk),
        jet_params=make(JetParams, jet_params),
        stars=make(StarfieldParams, stars),
        features=make(Features, features),
        march_cfg=make(MarchConfig, march_cfg),
        post=make(PostParams, post),
        spectral_coeffs=spectral_coeffs,
        nrs_params=(None if nrs_params is None
                    else nrs_params_from_numpy(nrs_params, device)),
    )
    return ensure_spectral_coeffs(scene)


def ensure_spectral_coeffs(scene: Scene) -> Scene:
    """Fill in the host spectral Chebyshev tables on a fused scene that
    needs them. A staged scene without them shades its spectral disk from
    the float64-built LUTs (``shading.disk_emission_lut_rows``), as the
    JAX package's does; one that carries them keeps the Chebyshev route."""
    if (scene.spectral_coeffs is not None or not scene.features.spectral_lut
            or not scene.features.disk or not scene.march_cfg.fused):
        return scene
    tables = spectral_kernel_tables(
        host(scene.bh.mass), host(scene.bh.spin), scene.disk
    )
    return dataclasses.replace(scene, spectral_coeffs=tables)


def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton_jitters(n: int, dtype=np.float32) -> np.ndarray:
    """n Halton(2, 3) sub-pixel offsets in [-0.5, 0.5]^2, (n, 2), formed in
    float64 and rounded once to ``dtype`` (float32 by default)."""
    return np.array(
        [[_halton(i + 1, 2) - 0.5, _halton(i + 1, 3) - 0.5] for i in range(n)],
        dtype,
    ).reshape(n, 2)


def resolve_device(device=None) -> torch.device:
    """``cuda`` when no device is named; raise where CUDA is absent. An
    explicit ``"cpu"`` selects the plain version of the kernel."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port renders on the GPU; pass "
                "device='cpu' to run the plain PyTorch version"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def fused_path_active(scene: Scene) -> bool:
    """True when ``render_sample`` takes the fused branch, whose kernel
    draws the shadow overlay itself (so ``render`` does not draw it
    again)."""
    return scene.march_cfg.use_pallas and scene.march_cfg.fused


def precull_config(scene: Scene, cfg: MarchConfig) -> MarchConfig:
    """render_sample's precull adjustment: jets accumulate emission all the
    way to the horizon, so they turn the precull off; the disk decides
    whether culled rays keep marching to the ISCO."""
    if not cfg.shadow_precull:
        return cfg
    return dataclasses.replace(cfg, shadow_precull=not scene.features.jets,
                               precull_keep_disk=scene.features.disk)


@spans.span("host_row")
def kernel_inputs(scene: Scene, jitter, device, dtype=torch.float32):
    """The render kernel's inputs for one sample: the parameter row on
    ``device`` (built in ``dtype``'s route, ``build_param_row``, and copied
    by ``_upload_row``) and the static configuration. In a frame that
    ``render`` records (while a profiler session is active,
    ``perf/spans.py``) the call is the span ``host_row``."""
    from blackhole_simulation_tpu_torch.ops.render import (
        RenderStatic,
        build_param_row,
        nrs_active,
    )

    cfg = precull_config(scene, scene.march_cfg)
    scene_f = dataclasses.replace(scene, march_cfg=cfg)
    row = _upload_row(build_param_row(scene_f, jitter, dtype), device)
    feats = scene.features
    st = RenderStatic(
        cfg=cfg, disk_on=feats.disk, spectral=feats.spectral_lut,
        starfield=feats.starfield, glow=feats.photon_ring_glow,
        disk=scene.disk, stars=scene.stars,
        width=scene.camera.width, height=scene.camera.height,
        jets=feats.jets, jet_params=scene.jet_params,
        overlay=feats.shadow_overlay, nrs_on=nrs_active(scene),
    )
    return row, st


@spans.span("row_upload")
def _upload_row(row: np.ndarray, device) -> torch.Tensor:
    """The host parameter row on ``device``: a blocking copy, which on a
    CUDA device waits for the stream. In a recorded frame the call is the
    span ``row_upload`` and a CUDA copy counts one ``stream_syncs``."""
    out = torch.from_numpy(row).to(device)
    if spans.on and out.is_cuda:
        spans.count("stream_syncs")
    return out


_DUMMY_U = (0.0, 100.0, 0.0, 0.0, -1.0, -1.0, 0.0, 0.0)
_DUMMY_THETA = (0.0, 100.0, 1.5707964, 0.0, -1.0, -1.0, 0.0, 0.0)


def _composite(scene: Scene, m, a, hit, crossings, n_crossings, r_min_ph,
               lam, state_rows, escape_rows, dummy, jet_rows,
               density_scale, intensity_scale, spectral_coeffs, luts):
    """Disk crossings front to back, the starfield behind escaped rays (from
    ``escape_rows`` of the state rows, captured rays taking the far-field
    ``dummy`` state so nothing non-finite reaches a masked lane), the jets'
    radiance and the photon-ring glow: (r, g, b) rows in ``lam``'s
    dtype."""
    from blackhole_simulation_tpu_torch._elementwise import div_c, maximum
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        isco_t,
        photon_sphere_t,
    )
    from blackhole_simulation_tpu_torch.render.march import HIT_ESCAPE
    from blackhole_simulation_tpu_torch.render.shading import (
        shade_crossings_rows,
        starfield_rows,
    )

    feats = scene.features
    escaped = hit == HIT_ESCAPE
    zero = torch.zeros_like(lam)
    if feats.disk:
        rgb, trans = shade_crossings_rows(
            m, a, isco_t(m, a), scene.disk, *crossings, n_crossings, lam,
            density_scale, intensity_scale, spectral=feats.spectral_lut,
            spectral_coeffs=spectral_coeffs, luts=luts,
        )
    else:
        rgb, trans = (zero, zero, zero), zero + 1.0
    if feats.starfield:
        srows = tuple(torch.where(escaped, state_rows[i], dummy[i])
                      for i in range(8))
        bg = starfield_rows(*escape_rows(srows, m, a), params=scene.stars)
        w_bg = torch.where(escaped, trans, 0.0)
        rgb = tuple(c + w_bg * b for c, b in zip(rgb, bg))
    if feats.jets:
        rgb = tuple(c + j for c, j in zip(rgb, jet_rows))
    if feats.photon_ring_glow:
        r_ph = photon_sphere_t(m, a)
        near = torch.exp(-14.0 * r_min_ph / maximum(r_ph, 1e-3))
        glow = torch.where(escaped, 0.6 * near, 0.0)
        order = div_c(torch.clamp(n_crossings, 0, 3).to(lam.dtype), 3.0)
        warm = (1.0, 0.82, 0.55)
        cool = (0.82, 0.88, 1.0)
        rgb = tuple(c + glow * (w + order * (k - w))
                    for c, w, k in zip(rgb, warm, cool))
    return rgb


def shade_march_rows(rows, m, a, scene: Scene, lam, density_scale=1.0,
                     intensity_scale=1.0, luts=None, dtype=None):
    """The staged composite (``_composite``) of MarchRows, as (r, g, b)
    rows in ``dtype`` (the rows' own, float32 or float64, when None).
    ``m``, ``a``: 0-dim tensors of that dtype; ``lam``: the (N,) conserved
    impact parameter L_z/E; ``luts``: the spectral disk's tables for this
    ``m`` and ``a`` (``scene_luts``), else looked up from them.
    Differentiable.

    CUDA rows take the composite kernel and its VJP kernel
    (``ops/composite.py::composite_rows``), bit for bit the plain
    composite's values, which raise where they refuse an input; the CPU
    takes ``_composite`` under autograd. So does the spectral disk's LUT
    branch on either device (a spectral scene without Chebyshev tables,
    ``shade_crossings_rows``' rule), whose tables' cotangent the kernel
    does not take."""
    from blackhole_simulation_tpu_torch.render.shading import (
        escape_direction_u_rows,
    )

    if dtype is not None:
        lam = lam.to(dtype)
    feats = scene.features
    lut_branch = (feats.disk and feats.spectral_lut
                  and scene.spectral_coeffs is None)
    if lam.is_cuda and not lut_branch:
        from blackhole_simulation_tpu_torch.ops.composite import (
            CompositeStatic,
            composite_rows,
        )

        return composite_rows(
            CompositeStatic.of(scene), m, a, rows.hit, rows.cross_r,
            rows.cross_phi, rows.cross_t, rows.n_crossings, rows.r_min_ph,
            lam, rows.state_u, rows.jet_radiance, density_scale,
            intensity_scale)
    return _composite(
        scene, m, a, rows.hit, (rows.cross_r, rows.cross_phi, rows.cross_t),
        rows.n_crossings, rows.r_min_ph, lam, rows.state_u,
        escape_direction_u_rows, _DUMMY_U, rows.jet_radiance, density_scale,
        intensity_scale, scene.spectral_coeffs, luts)


def shade_sample_rows(result, m, a, scene: Scene, y0, density_scale=1.0,
                      intensity_scale=1.0):
    """The composite of a packed ``MarchResult`` (the oracle's, or
    ``march``'s) from its (N, 8) theta-form initial states ``y0``, as
    (r, g, b) rows in the dtype it is given (float64 for the oracle): the
    JAX twin's ``shade_sample_rows`` (pipeline.py:188). A spectral disk
    shades from the LUTs built in that dtype, never from Chebyshev
    tables."""
    from blackhole_simulation_tpu_torch.render.shading import (
        escape_direction_rows,
    )

    lam = -y0[:, 7] / torch.where(torch.abs(y0[:, 4]) < 1e-12, -1.0, y0[:, 4])
    return _composite(
        scene, m, a, result.hit,
        (result.cross_r.T, result.cross_phi.T, result.cross_t.T),
        result.n_crossings, result.r_min_ph, lam, result.state.T,
        escape_direction_rows, _DUMMY_THETA, result.jet_radiance.T,
        density_scale, intensity_scale, None, None)


def shade_sample(result, m, a, scene: Scene, y0, density_scale=1.0,
                 intensity_scale=1.0) -> torch.Tensor:
    """(N, 3) radiance of a packed ``MarchResult`` (``shade_sample_rows``
    stacked)."""
    return torch.stack(shade_sample_rows(result, m, a, scene, y0,
                                         density_scale, intensity_scale),
                       dim=-1)


def conserved_lam(rays: torch.Tensor) -> torch.Tensor:
    """lambda = L_z / E = -p_phi / p_t of (8, N) rows."""
    return -rays[7] / torch.where(torch.abs(rays[4]) < 1e-12, -1.0, rays[4])


def scene_luts(scene: Scene, device, dtype=torch.float32):
    """The staged spectral composite's tables in ``dtype`` for the scene's
    own mass and spin (in ``dtype``, the values ``_mass_spin`` marches) on
    ``device``: cached, so a frame reads nothing back, or, where autograd
    wants a derivative of mass or spin, built in the graph from them
    (``shading.disk_luts_for``); None where the disk shades without
    them."""
    from blackhole_simulation_tpu_torch.render.shading import disk_luts_for

    feats = scene.features
    if (not feats.disk or not feats.spectral_lut
            or scene.spectral_coeffs is not None):
        return None
    m, a = _mass_spin(scene, device, dtype)
    return disk_luts_for(m, a, scene.disk, torch.device(device), dtype)


def _mass_spin(scene: Scene, device, dtype=torch.float32):
    """The scene's mass and spin as 0-dim ``dtype`` tensors on ``device``
    (keeping a tensor leaf's graph; a number is rounded once, so float64
    keeps it unrounded, as JAX's ``bh.mass.astype(float64)``)."""
    return (leaf(scene.bh.mass, dtype, device),
            leaf(scene.bh.spin, dtype, device))


def check_render_dtype(dtype) -> None:
    """ValueError unless ``dtype`` is float32 or float64, the JAX
    package's render dtypes."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got "
                         f"{dtype}")


def _refuse_kernel_grad(scene: Scene, where: str):
    """NotImplementedError where autograd wants a derivative of a scene that
    the JAX package renders on a Pallas kernel, which has no VJP: a fused
    scene (``pallas_render_sample``), or ``use_pallas`` without jets (the
    staged march's ``pallas_march_u``); ``jax.grad`` of either raises
    ("Linearization failed")."""
    cfg = scene.march_cfg
    if not cfg.use_pallas or not grad_wanted(*scene.leaves()):
        return
    if cfg.fused:
        raise NotImplementedError(
            f"{where}: a fused scene renders on the render kernel, which "
            "has no gradient path, as the JAX package's pallas_render_sample "
            "has no VJP (jax.grad raises); take use_pallas=False")
    if not scene.features.jets:
        raise NotImplementedError(
            f"{where}: use_pallas marches on the march kernel forward only, "
            "as the JAX package's pallas_march_u has no VJP (jax.grad "
            "raises); take use_pallas=False")


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of ``x``, ascending, ties in index
    order: ``jax.lax.top_k(-x, k)``'s indices (it returns equal values
    lowest index first, which ``torch.topk`` does not promise)."""
    return torch.sort(x, stable=True).indices[:k]


def select_band(band: torch.Tensor, height: int, width: int, k: int,
                refine_band: float) -> torch.Tensor:
    """``refine_critical_band``'s selection (pipeline.py:360-391): the (k,)
    row-major ids of the k lowest band values, and n = band.numel() in place
    of those not below ``refine_band``.

    A 4x4-block form runs when height and width are multiples of 4, k of 16
    and k >= 2048, as in the JAX package: the 2k/16 blocks of least minimum
    first, then the k least pixels among theirs. It can leave band pixels
    coarse when more than 2k of them exist (ROADMAP Queue 3, reference
    fault 1); the port reproduces that."""
    n = band.shape[0]
    blk = 4
    if height % blk == 0 and width % blk == 0 and k % (blk * blk) == 0 \
            and k >= 2048:
        wb = width // blk
        bb = band.reshape(height // blk, blk, wb, blk).amin(dim=(1, 3))
        kb = min(2 * k // (blk * blk), bb.numel())
        bsel = _smallest(bb.reshape(-1), kb)
        by, bx = bsel // wb, bsel % wb
        d = torch.arange(blk, device=band.device)
        cand = ((by[:, None, None] * blk + d[None, :, None]) * width
                + bx[:, None, None] * blk + d[None, None, :]).reshape(-1)
        vals = band[cand]
        ci = _smallest(vals, k)
        sel, vals = cand[ci], vals[ci]
    else:
        sel = _smallest(band, k)
        vals = band[sel]
    return torch.where(vals < refine_band, sel, n)


def refine_critical_band(scene: Scene, cfg: MarchConfig, jitter,
                         rgb: torch.Tensor, band: torch.Tensor,
                         dtype=torch.float32, pix_ids=None) -> torch.Tensor:
    """The critical-band refinement pass: the rays of the pixels that
    ``select_band`` picks are born again (``camera_rays_u`` at their ids,
    with the sample's jitter, in ``dtype``), re-marched as one batch at
    ``refinement_config(cfg)`` (on the march kernel for CUDA tensors),
    shaded by ``shade_march_rows``, and written over their pixels (which
    takes ``rgb``'s dtype: float32 planes of the fused kernel keep it).

    ``rgb``: (3, N) radiance; ``band``: (N,) metric in the same pixel
    order; ``pix_ids``: the row-major pixel id of each position, None for
    row-major order (the render paths pass row-major planes). The
    selection reads ``band`` as a row-major frame whatever its order, as
    the JAX package's does. Returns the new (3, N). Every one of the k rays is marched; those not
    in the band (id n) are dropped by the scatter, as the JAX package's
    ``mode="drop"`` does. Nothing here waits on the device."""
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import (
        march_rows,
        refinement_config,
    )

    n = band.shape[0]
    k = min(cfg.refine_budget, n)
    sel = select_band(band, scene.camera.height, scene.camera.width, k,
                      cfg.refine_band)
    m, a = _mass_spin(scene, band.device, dtype)
    ids = torch.clamp(sel, max=n - 1)
    if pix_ids is not None:
        ids = torch.as_tensor(pix_ids, device=band.device)[ids]
    rays = camera_rays_u(scene.camera, m, a, pix_ids=ids, jitter=jitter,
                         dtype=dtype)
    jets = scene.jet_params if scene.features.jets else None
    rows = march_rows(rays, m, a, refinement_config(cfg), jets=jets)
    rgb_f = shade_march_rows(rows, m, a, scene, conserved_lam(rays),
                             luts=scene_luts(scene, band.device, dtype))
    # Column n catches the out-of-band entries and is cut off.
    out = torch.cat([rgb, rgb.new_zeros((3, 1))], dim=1)
    out[:, sel] = torch.stack(rgb_f).to(out.dtype)
    return out[:, :n]


def _staged_sample(scene: Scene, cfg: MarchConfig, jitter, device, dtype):
    """The staged branch: (3, H, W) ``dtype`` radiance planes."""
    from blackhole_simulation_tpu_torch.models.nrs import nrs_far_field_rows
    from blackhole_simulation_tpu_torch.ops.pallas_march import (
        from_block_order,
        to_block_order,
    )
    from blackhole_simulation_tpu_torch.ops.render import (
        nrs_active,
        nrs_b_min,
    )
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import (
        march_rows,
        precull_threshold,
    )
    from blackhole_simulation_tpu_torch.render.precull import (
        critical_band_metric_u,
    )
    from blackhole_simulation_tpu_torch.render.shading import starfield_rows

    h, w = scene.camera.height, scene.camera.width
    m, a = _mass_spin(scene, device, dtype)
    jets = scene.jet_params if scene.features.jets else None
    block = cfg.use_pallas and jets is None
    ids = to_block_order(torch.arange(h * w, device=device), h, w) \
        if block else None
    rays = camera_rays_u(scene.camera, m, a, pix_ids=ids, jitter=jitter,
                         dtype=dtype)
    # The NRS skip, without jets only (the fused kernel runs it with jets
    # too, pipeline.py:467-471 against pallas_render.py:595).
    nrs_on = nrs_active(scene) and jets is None
    thr = None
    if nrs_on:
        far, far_dirs = nrs_far_field_rows(scene.nrs_params, rays, m, a,
                                           b_min=nrs_b_min(scene))
        thr = torch.where(far, 1e9, precull_threshold(rays, m, a, cfg))
    rows = march_rows(rays, m, a, cfg, thr=thr, jets=jets)
    rgb = shade_march_rows(rows, m, a, scene, conserved_lam(rays),
                           luts=scene_luts(scene, device, dtype))
    if nrs_on and scene.features.starfield:
        bg_far = starfield_rows(*far_dirs, params=scene.stars)
        rgb = tuple(torch.where(far, b_, c) for c, b_ in zip(rgb, bg_far))
    if block:
        rgb = tuple(from_block_order(c, h, w) for c in rgb)
    rgb = torch.stack(rgb)
    if cfg.refine_band > 0.0:
        # The band metric of the born rays, in row order (it selects
        # pixels, and has no derivative).
        band = critical_band_metric_u(m.detach(), a.detach(), rays.detach(),
                                      cfg.refine_band, cfg.refine_pole_w)
        if block:
            band = from_block_order(band, h, w)
        rgb = refine_critical_band(scene, cfg, jitter, rgb, band, dtype)
    return rgb.reshape(3, h, w)


@spans.span("sample")
def render_sample(scene: Scene, jitter, device,
                  dtype=torch.float32) -> torch.Tensor:
    """One jittered sub-sample: (3, H, W) linear radiance planes, in
    ``dtype`` on the staged branch and float32 from the fused kernel (see
    the module docstring's routes). In a frame that ``render`` records the
    call is the span ``sample``; called on its own it records nothing."""
    from blackhole_simulation_tpu_torch.ops.render import render_planes_kernel

    check_render_dtype(dtype)
    _refuse_kernel_grad(scene, "render_sample")
    if fused_path_active(scene):
        row, st = kernel_inputs(scene, jitter, device, dtype)
        planes = render_planes_kernel(row, st)
        if st.cfg.refine_band <= 0.0:
            return planes
        h, w = st.height, st.width
        rgb = refine_critical_band(scene, st.cfg, jitter,
                                   planes[:3].reshape(3, h * w),
                                   planes[3].reshape(h * w), dtype)
        return rgb.reshape(3, h, w)
    return _staged_sample(scene, precull_config(scene, scene.march_cfg),
                          jitter, device, dtype)


@spans.frame
def render(scene: Scene, n_samples: int = 1, device=None,
           dtype=torch.float32) -> torch.Tensor:
    """Render the scene to a tone-mapped (H, W, 3) image: the mean of
    ``n_samples`` Halton-jittered samples (jitters in ``dtype``, summed
    from zeros in ``dtype``), the shadow overlay (on the staged branch; the
    fused kernel draws it per sample), then ``tonemap``. float64 on the
    staged route with ``dtype=torch.float64``; see the module docstring
    for the fused one.

    While a torch profiler session is active in the calling thread the
    call is recorded (``perf/spans.py``): the span ``frame``, the spans
    ``sample``, ``host_row`` and ``row_upload`` inside it, and its
    ``stream_syncs``; otherwise nothing is recorded."""
    device = resolve_device(device)
    check_render_dtype(dtype)
    scene = ensure_spectral_coeffs(scene)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    if n_samples == 1:
        acc = render_sample(scene, None, device, dtype)
    else:
        cam = scene.camera
        acc = torch.zeros((3, cam.height, cam.width), dtype=dtype,
                          device=device)
        for jit in halton_jitters(n_samples, np_dtype):
            acc = acc + render_sample(scene, jit, device, dtype)
        acc = acc / n_samples
    img = acc.permute(1, 2, 0)
    if scene.features.shadow_overlay and not fused_path_active(scene):
        img = _staged_overlay(scene, img, device, dtype)
    return tonemap(img, scene.post)


def _staged_overlay(scene: Scene, img: torch.Tensor, device,
                    dtype=torch.float32) -> torch.Tensor:
    """The analytic critical curve over the (H, W, 3) radiance, from the
    unjittered theta-form camera rays in ``dtype``, with a line ~1.5
    pixels of impact parameter wide and at least 0.06 M (pipeline.py:
    557-575): a tensor in the camera's fov and r, as JAX's traced width
    is."""
    from blackhole_simulation_tpu_torch.render.camera import camera_rays
    from blackhole_simulation_tpu_torch.render.overlay import shadow_overlay

    cam = scene.camera
    m, a = _mass_spin(scene, device, dtype)
    f64 = lambda x: leaf(x, torch.float64, device)
    pix_b = (f64(cam.fov) / cam.height * f64(cam.r)).to(dtype)
    width = torch.maximum(0.06 * m, 1.5 * pix_b)
    out = shadow_overlay(img.reshape(-1, 3),
                         camera_rays(cam, m, a, dtype=dtype), m, a,
                         cam.theta, line_width=width)
    return out.reshape(img.shape)


def render_radiance(scene: Scene, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Un-tonemapped single-sample radiance, (H, W, 3), in ``dtype`` on the
    staged route (float32 from the fused kernel): the differentiable
    target of inverse rendering and of the oracle gates (see the module
    docstring for its gradients and its routes)."""
    device = resolve_device(device)
    planes = render_sample(ensure_spectral_coeffs(scene), None, device, dtype)
    return planes.permute(1, 2, 0)


def render_sample_scaled(scene: Scene, jitter=None, density_scale=1.0,
                         intensity_scale=1.0, device=None,
                         dtype=torch.float32) -> torch.Tensor:
    """(H*W, 3) ``dtype`` radiance of the staged render with the disk's
    density and intensity scaled by ``density_scale`` / ``intensity_scale``
    (numbers or 0-d tensors): the differentiable entry of the inverse path
    and the density-gradient gate (JAX pipeline.py:520). It marches through
    ``march_rows`` (the march kernel forward, the gradient kernel backward
    where autograd wants it, ``start_jitter`` included), so autograd
    reaches the scales and the scene's leaves; like JAX's, it refuses a
    derivative of the march with ``use_pallas`` (``march_rows``), and
    float64 with ``use_pallas`` and no jets."""
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import march_rows

    device = resolve_device(device)
    check_render_dtype(dtype)
    m, a = _mass_spin(scene, device, dtype)
    rays = camera_rays_u(scene.camera, m, a, jitter=jitter, dtype=dtype)
    rows = march_rows(rays, m, a, scene.march_cfg)
    rgb = shade_march_rows(rows, m, a, scene, conserved_lam(rays),
                           density_scale=density_scale,
                           intensity_scale=intensity_scale,
                           luts=scene_luts(scene, device, dtype))
    return torch.stack(rgb, dim=-1)


def oracle_render(scene: Scene, device=None) -> torch.Tensor:
    """Float64 oracle radiance (H, W, 3): the camera's rays in float64, the
    adaptive-RKF45 oracle (``geodesic/oracle.py``) in place of the march,
    and the same shading (``shade_sample``) in float64, on ``device``
    (``cuda`` unless the caller passes ``"cpu"``)."""
    from blackhole_simulation_tpu_torch.geodesic.oracle import oracle_march
    from blackhole_simulation_tpu_torch.render.camera import camera_rays

    device = resolve_device(device)
    f64 = lambda v: torch.tensor(host(v), dtype=torch.float64, device=device)
    m, a = f64(scene.bh.mass), f64(scene.bh.spin)
    cam = scene.camera
    rays = camera_rays(cam, m, a, dtype=torch.float64)
    result = oracle_march(rays, m, a, scene.march_cfg)
    return shade_sample(result, m, a, scene, rays).reshape(
        cam.height, cam.width, 3)
