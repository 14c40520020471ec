"""The render pipeline: scene -> supersampled, tone-mapped image.

Counterpart of ``blackhole_simulation_tpu/render/pipeline.py``: ``Features``
(:49), ``Scene`` (:87), ``ensure_spectral_coeffs`` (:131),
``halton_jitters`` (:181), the fused branch of ``render_sample`` (:434-451),
``render`` (:581) and ``render_radiance`` (:600).

Every sample goes through the fused render kernel (``ops/render.py``,
``csrc/render.cu``): one launch per Halton-jittered sample, accumulated and
tone-mapped on the device. The entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, which selects the plain PyTorch version of
the kernel. With no CUDA device and no explicit CPU request they raise; they
never fall back to the CPU.

Not in this slice (``render_sample`` raises NotImplementedError): the
staged path (``use_pallas`` or ``fused`` off), jets, ``start_jitter``, the
critical-band refinement (``refine_band``), the NRS far field, the shadow
overlay and the AB3 march (``multistep``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from blackhole_simulation_tpu_torch.geometry.metrics import Kerr
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
    None (then ``render`` builds them)."""

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
        bh = Kerr(mass=float(mass), spin=float(spin))
        scene = cls(bh=bh, camera=camera or Camera.create(), **kw)
        return ensure_spectral_coeffs(scene)


def scene_from_numpy(*, mass, spin, camera: dict, march_cfg: dict | None = None,
                     features: dict | None = None, disk: dict | None = None,
                     stars: dict | None = None, post: dict | None = None,
                     jet_params: dict | None = None,
                     spectral_coeffs=None) -> Scene:
    """Build the port's Scene from a JAX Scene's leaves and static fields
    given as plain numbers and numpy arrays: ``mass`` and ``spin``; the
    camera's r/theta/phi/fov/roll/width/height; and each static dataclass
    (MarchConfig, Features, DiskParams, StarfieldParams, PostParams,
    JetParams) as a dict of its fields (``dataclasses.asdict``). The
    ``spectral_coeffs`` tables, if given, are used as they are."""

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
    )
    return ensure_spectral_coeffs(scene)


def ensure_spectral_coeffs(scene: Scene) -> Scene:
    """Fill in the host spectral tables on a scene that needs them."""
    if (scene.spectral_coeffs is not None or not scene.features.spectral_lut
            or not scene.features.disk):
        return scene
    tables = spectral_kernel_tables(
        float(scene.bh.mass), float(scene.bh.spin), scene.disk
    )
    return dataclasses.replace(scene, spectral_coeffs=tables)


def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def halton_jitters(n: int) -> np.ndarray:
    """n Halton(2, 3) sub-pixel offsets in [-0.5, 0.5]^2, float32 (n, 2)."""
    return np.array(
        [[_halton(i + 1, 2) - 0.5, _halton(i + 1, 3) - 0.5] for i in range(n)],
        np.float32,
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


def _check_slice(scene: Scene, cfg: MarchConfig) -> None:
    """Refuse what this slice of the port does not run."""
    feats = scene.features
    missing = []
    if not (cfg.use_pallas and cfg.fused):
        missing.append("the staged path (MarchConfig.use_pallas/fused off)")
    if feats.jets:
        missing.append("jets")
    if cfg.start_jitter > 0.0:
        missing.append("start_jitter")
    if cfg.refine_band > 0.0:
        missing.append("critical-band refinement (refine_band)")
    if feats.nrs_far_field and scene.nrs_params is not None:
        missing.append("the NRS far field")
    if feats.shadow_overlay:
        missing.append("the shadow overlay")
    if cfg.multistep:
        missing.append("the AB3 march (multistep)")
    if missing:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(missing)
        )


def kernel_inputs(scene: Scene, jitter, device):
    """The render kernel's inputs for one sample: the parameter row on
    ``device`` and the static configuration. Raises NotImplementedError for
    what this slice does not run."""
    from blackhole_simulation_tpu_torch.ops.render import (
        RenderStatic,
        build_param_row,
    )

    cfg = scene.march_cfg
    _check_slice(scene, cfg)
    if cfg.shadow_precull:
        cfg = dataclasses.replace(
            cfg, shadow_precull=not scene.features.jets,
            precull_keep_disk=scene.features.disk,
        )
    scene_f = dataclasses.replace(scene, march_cfg=cfg)
    row = torch.from_numpy(build_param_row(scene_f, jitter)).to(device)
    feats = scene.features
    st = RenderStatic(
        cfg=cfg, disk_on=feats.disk, spectral=feats.spectral_lut,
        starfield=feats.starfield, glow=feats.photon_ring_glow,
        disk=scene.disk, stars=scene.stars,
        width=scene.camera.width, height=scene.camera.height,
    )
    return row, st


def render_sample(scene: Scene, jitter, device) -> torch.Tensor:
    """One jittered sub-sample: (3, H, W) float32 linear radiance planes."""
    from blackhole_simulation_tpu_torch.ops.render import render_planes_kernel

    return render_planes_kernel(*kernel_inputs(scene, jitter, device))


def render(scene: Scene, n_samples: int = 1, device=None) -> torch.Tensor:
    """Render the scene to a tone-mapped (H, W, 3) float32 image: the mean
    of ``n_samples`` Halton-jittered samples, then ``tonemap``."""
    device = resolve_device(device)
    scene = ensure_spectral_coeffs(scene)
    if n_samples == 1:
        acc = render_sample(scene, None, device)
    else:
        acc = None
        for jit in halton_jitters(n_samples):
            s = render_sample(scene, jit, device)
            acc = s if acc is None else acc + s
        acc = acc / n_samples
    return tonemap(acc.permute(1, 2, 0), scene.post)


def render_radiance(scene: Scene, device=None) -> torch.Tensor:
    """Un-tonemapped single-sample radiance, (H, W, 3) float32."""
    device = resolve_device(device)
    planes = render_sample(ensure_spectral_coeffs(scene), None, device)
    return planes.permute(1, 2, 0)
