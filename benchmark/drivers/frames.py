"""Closed-loop frames: ``render(scene, n_samples)`` of the port, one frame
after another, each on the next pose of a fixed camera track (the
``grand_survey`` director over one period), each timed from its call to
the synchronise after it. Every run starts at the track's first pose, so
every seed does the same work; the seed sets the frames whose images are
checked and the rows checked in each."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import counts, director
from benchmark.reference import image, shading


def port_scene(config: dict, pose, device):
    """The port's Scene of the configuration at one camera pose."""
    from blackhole_simulation_tpu_torch.render import (
        Camera,
        DiskParams,
        Features,
        MarchConfig,
        PostParams,
        Scene,
        StarfieldParams,
    )

    r, theta, phi = pose
    cam = Camera.create(r=r, theta=theta, phi=phi,
                        fov=config["camera"]["fov"], width=config["width"],
                        height=config["height"])
    return Scene.create(
        mass=config["mass"], spin=config["spin"], camera=cam,
        disk=DiskParams(**config.get("disk", {})),
        stars=StarfieldParams(**config.get("stars", {})),
        features=Features(**config["features"]),
        march_cfg=MarchConfig(**config["march"]), post=PostParams(**config["post"]))


@dataclasses.dataclass
class Kept:
    frame: int
    pose: int
    y0: int
    image: torch.Tensor


class Frames:
    """One run of a frame cell."""

    def __init__(self, spec):
        self.spec = spec
        self.config, self.traffic = spec.config, spec.traffic
        self.device = spec.device
        self.n_samples = int(self.traffic["n_samples"])
        self.poses = director.track(int(self.traffic["poses"]),
                                    float(self.traffic["period_s"]))
        rng = np.random.default_rng(spec.seed)
        span = int(self.traffic["check_span"])
        self.check = sorted(rng.choice(span, int(self.traffic["check_frames"]),
                                       replace=False).tolist())
        h, rows = self.config["height"], int(self.traffic["band_rows"])
        lo, hi = int(0.2 * h), max(int(0.8 * h) - rows, int(0.2 * h) + 1)
        # the checked frames' bands, and one for the window's last frame
        self.bands = rng.integers(lo, hi, len(self.check) + 1).tolist()
        self.rows = rows

    def spans(self) -> list:
        """The calls to record as spans in a traced window: each frame's
        call into the program (``frame``) and the tone map inside it
        (``post``; ``render`` and the sharded render reach it from two
        modules)."""
        import blackhole_simulation_tpu_torch.render.pipeline as pipeline
        import blackhole_simulation_tpu_torch.render.post as post

        return [(self, "render", "frame"), (pipeline, "tonemap", "post"),
                (post, "tonemap", "post")]

    def pose_of(self, frame: int) -> int:
        return frame % len(self.poses)

    def setup(self):
        """Every pose's scene, and one frame of each: builds the render
        kernel and fills the program's per-camera caches."""
        from blackhole_simulation_tpu_torch.render import render

        self.render = render
        self.scenes = [port_scene(self.config, p, self.device)
                       for p in self.poses]
        for scene in self.scenes:
            render(scene, n_samples=self.n_samples, device=self.device)
        _sync(self.device)

    def window(self, seconds: float) -> dict:
        kept, lat = [], []
        check = {f: i for i, f in enumerate(self.check)}
        start = time.perf_counter()
        frame = 0
        while True:
            t0 = time.perf_counter()
            img = self.render(self.scenes[self.pose_of(frame)],
                              n_samples=self.n_samples, device=self.device)
            if frame in check:
                y0 = self.bands[check[frame]]
                kept.append(Kept(frame, self.pose_of(frame), y0,
                                 img[y0:y0 + self.rows].clone()))
            _sync(self.device)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            frame += 1
            if t1 - start >= seconds:
                break
        y0 = self.bands[-1]
        kept.append(Kept(frame - 1, self.pose_of(frame - 1), y0,
                         img[y0:y0 + self.rows]))
        self.kept, self.frames, self.latencies = kept, frame, lat
        window = t1 - start
        return {"window_s": window, "attempted": frame, "failed": 0,
                "metrics": {"frame_ms": 1e3 * window / frame,
                            "frame_p95_ms": 1e3 * p95(lat)}}

    def release(self):
        self.scenes = None

    def reference_band(self, pose: int, y0: int, dtype=torch.float32):
        """The reference's tone-mapped rows [y0, y0 + band_rows) of the
        frame at ``pose``, in ``dtype``."""
        if not hasattr(self, "tables"):
            self.tables = shading.spectral_tables(
                self.config["mass"], self.config["spin"],
                shading.Disk(**self.config.get("disk", {})))
        r, theta, phi = self.poses[pose]
        scene = image.Scene.of(self.config, dtype, self.device, r=r,
                               theta=theta, phi=phi)
        with torch.no_grad():
            return image.band(scene, y0, y0 + self.rows, self.n_samples,
                              self.tables)

    def numbers(self, pairs) -> dict:
        """The mean |difference| over every pixel and channel of the
        (image, reference) band pairs, and the share of pixels whose
        largest channel difference is above the limits' ``pixel_tol``."""
        d = torch.cat([(a.float() - b.float()).abs().reshape(-1, 3)
                       for a, b in pairs])
        tol = float(self.spec.limits["pixel_tol"])
        return {"mean_abs_diff": float(d.mean()),
                "bad_pixel_share": float((d.amax(dim=1) > tol).double().mean())}

    def checks(self) -> dict:
        """The kept bands against the reference's bands of the same frames
        and rows."""
        return self.numbers([(k.image, self.reference_band(k.pose, k.y0))
                             for k in self.kept])

    def control(self) -> dict:
        """The reference in bfloat16 in the program's place, on the frames
        and rows a run checks (the window's last frame taken as the one
        after the checked span)."""
        plan = [(self.pose_of(f), y0) for f, y0 in
                zip(self.check + [int(self.traffic["check_span"])],
                    self.bands)]
        return self.numbers([(self.reference_band(p, y0, torch.bfloat16),
                              self.reference_band(p, y0)) for p, y0 in plan])

    def work(self, seed_sample: int) -> dict:
        """The traced window's least work: each pose's mean steps per ray
        from the reference, on a seeded sample of its rays (pixels and
        sub-pixel jitters), times the pose's frames."""
        n = int(self.traffic["steps_sample"])
        h, w = self.config["height"], self.config["width"]
        jit = (image.halton_jitters(self.n_samples) if self.n_samples > 1
               else np.zeros((1, 2), np.float32))
        rng = np.random.default_rng(seed_sample)
        frames_of = np.bincount([self.pose_of(f) for f in range(self.frames)],
                                minlength=len(self.poses))
        used = [p for p in range(len(self.poses)) if frames_of[p]]
        scenes, samples = [], []
        for p in used:
            r, theta, phi = self.poses[p]
            scenes.append(image.Scene.of(self.config, torch.float32,
                                         self.device, r=r, theta=theta,
                                         phi=phi))
            j = jit[rng.integers(len(jit), size=n)]
            samples.append((torch.as_tensor(rng.integers(h * w, size=n),
                                            device=self.device),
                            torch.as_tensor(j[:, 0], device=self.device),
                            torch.as_tensor(j[:, 1], device=self.device)))
        with torch.no_grad():
            steps = image.mean_steps(scenes, samples)
        pixels = h * w * self.n_samples
        ops = sum(frames_of[p] * counts.render_ops(s * pixels, pixels)
                  for p, s in zip(used, steps))
        return {"frames": self.frames,
                "latencies_s": self.latencies,
                "render_ops": ops,
                "render_bytes": self.frames * counts.render_bytes(pixels),
                "post_bytes": self.frames * counts.post_bytes(h * w),
                "steps_per_ray": float(np.average(steps,
                                                  weights=frames_of[used]))}


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values), 95))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(spec) -> dict:
    from benchmark import session

    return session.run(spec, Frames(spec))
