"""Closed-loop inverse fits: whole fits of ``cli inverse``'s default AD
curriculum (``ad_inverse_render``: the steps split evenly over the
(march steps, pool) stages, each stage a ``make_ad_inverse_step`` of the
port with its learning rate, the cosine schedule over its steps and fresh
Adam moments), one after another, each from the same initial parameters
against the same target, each step's loss read on the host as
``ad_inverse_render`` reads it. The window ends with the fit in which
``--seconds`` elapse, so every run measures the same mix of stages. Each
step renders and differentiates one frame: ``frame_ms`` is the window
over the steps completed.

The seed picks one step of each stage in the first fit; the check runs the
reference's step (``reference/inverse.py``) from that step's entering
state and compares what the port produced: the loss, the gradient
recovered from the new first moment, g = (m' - b1 m) / (1 - b1), and the
update of the parameters."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import inverse_counts
from benchmark.reference import inverse

B1 = inverse.ADAM["b1"]


def port_scene(config: dict, device):
    """The true scene as ``cli inverse`` builds it (``scene_from_params`` of
    the configuration's parameters); raises where it is not the scene the
    configuration states."""
    from blackhole_simulation_tpu_torch.configs.simulation import (
        SimulationParams,
        scene_from_params,
    )

    scene = scene_from_params(SimulationParams(**config["params"]),
                              width=config["width"], height=config["height"],
                              device=device)
    cam, cfg = scene.camera, scene.march_cfg
    stated = dict(config["camera"], width=config["width"],
                  height=config["height"], mass=config["mass"],
                  spin=config["spin"], **config["march"],
                  **config["features"], **config["disk"])
    have = dict(dataclasses.asdict(cam), mass=scene.bh.mass,
                spin=scene.bh.spin, **dataclasses.asdict(cfg),
                **dataclasses.asdict(scene.features),
                **dataclasses.asdict(scene.disk))
    on_card = torch.device(device).type == "cuda"
    kernel_path = {"use_pallas", "fused", "approx_recip"}
    wrong = {k: (v, have[k]) for k, v in stated.items()
             if (on_card or k not in kernel_path) and have[k] != v}
    if wrong:
        raise ValueError(
            f"the port's scene is not the configuration's: {wrong}")
    return scene


@dataclasses.dataclass
class Kept:
    """A checked step: its stage, its entering state and what the port
    made of it."""

    stage: int
    t: int
    params: list
    m: list
    v: list
    loss: float
    new_params: list
    new_m: list


def _values(inv) -> list:
    return [float(x) for x in inv.leaves()]


class Fits:
    """One run of the inverse cell."""

    def __init__(self, spec):
        self.config, self.traffic = spec.config, spec.traffic
        self.device = spec.device
        t = self.traffic
        n = len(t["stages"])
        self.per = max(int(t["steps"]) // n, 1)
        self.stages = [dict(march_steps=int(ms), pool=int(pool), lr=float(lr),
                            total_steps=self.per, clip=float(t["clip"]))
                       for (ms, pool), lr in zip(t["stages"], t["lrs"])]
        rng = np.random.default_rng(spec.seed)
        self.checked = [int(i) for i in rng.integers(self.per, size=n)]
        self.fit_ref = inverse.Fit.of(self.config)

    def spans(self) -> list:
        """The benchmark's span around each call of a step of the port."""
        return [(self, "_step", "step")]

    def _step(self, fn, state):
        return fn(state, self.target)

    def setup(self):
        """The true scene, its target, the stages' steps, and a step of each
        (builds the kernels, fills the caches)."""
        from blackhole_simulation_tpu_torch.parallel import train
        from blackhole_simulation_tpu_torch.render import render_radiance

        self.train = train
        self.scene = scene = port_scene(self.config, self.device)
        self.target = render_radiance(scene, device=self.device)
        h, w = self.config["height"], self.config["width"]
        for s in self.stages:
            if h % s["pool"] or w % s["pool"]:
                raise ValueError(f"pool {s['pool']} does not divide {w}x{h}")
        self.steps = [train.make_ad_inverse_step(
            scene, None, s["lr"], pool=s["pool"],
            march_steps=s["march_steps"], clip=s["clip"],
            total_steps=s["total_steps"], device=self.device)
            for s in self.stages]
        init = self.init()
        for fn in self.steps:
            _, loss = fn((init, train.init_opt_state(init)), self.target)
            float(loss)
        _sync(self.device)

    def init(self):
        return self.train.InverseParams.init(**self.config["init"],
                                             device=self.device)

    def fit(self, keep: bool):
        """One whole fit; with ``keep`` the checked steps are kept. Returns
        the losses and the final parameters."""
        train = self.train
        params = self.init()
        losses = []
        for s, fn in enumerate(self.steps):
            state = (params, train.init_opt_state(params))
            for i in range(self.per):
                entering = state
                state, loss = self._step(fn, state)
                losses.append(float(loss))
                if keep and i == self.checked[s]:
                    p, (m, v, t) = entering
                    self.kept.append(Kept(
                        s, int(t), _values(p), _values(m), _values(v),
                        losses[-1], _values(state[0]),
                        _values(state[1][0])))
            params = state[0]
        return losses, params

    def window(self, seconds: float) -> dict:
        self.kept = []
        start = time.perf_counter()
        fits, failed = 0, 0
        while True:
            losses, _ = self.fit(keep=fits == 0)
            failed += sum(not np.isfinite(x) for x in losses)
            fits += 1
            t1 = time.perf_counter()
            if t1 - start >= seconds:
                break
        self.fits = fits
        steps = fits * self.per * len(self.stages)
        window = t1 - start
        return {"window_s": window, "attempted": steps, "failed": failed,
                "metrics": {"frame_ms": 1e3 * window / steps}}

    def release(self):
        self.steps = self.scene = None

    def reference(self, k: Kept, dtype=torch.float32) -> dict:
        """The reference's step from a kept step's entering state, in
        ``dtype``, on the port's target."""
        return inverse.step(self.fit_ref, self.stages[k.stage],
                            (k.params, k.m, k.v, k.t), self.target, dtype)

    def numbers(self, pairs) -> dict:
        """The largest over the (got, want) pairs of each step's relative
        differences (norms over the four parameters): ``loss_rel`` of the
        loss, ``grad_rel`` of the gradient and ``update_rel`` of the update
        params' - params. Anything not finite reads inf."""
        out = {"loss_rel": 0.0, "grad_rel": 0.0, "update_rel": 0.0}
        for got, want in pairs:
            for key in ("loss", "grad", "update"):
                d = _rel(got[key], want[key])
                out[f"{key}_rel"] = max(out[f"{key}_rel"],
                                        d if np.isfinite(d) else np.inf)
        return out

    @staticmethod
    def port_result(k: Kept) -> dict:
        """What the port made of a kept step: its loss, the gradient that
        entered its first moment and its update."""
        return {"loss": [k.loss],
                "grad": (np.array(k.new_m) - B1 * np.array(k.m)) / (1.0 - B1),
                "update": np.array(k.new_params) - np.array(k.params)}

    @staticmethod
    def ref_result(r: dict, k: Kept) -> dict:
        """The same of the reference's step ``r`` from ``k``'s state."""
        f = lambda xs: np.array([float(x) for x in xs], np.float64)
        return {"loss": [float(r["loss"])], "grad": f(r["grad"]),
                "update": f(r["params"]) - np.array(k.params)}

    def checks(self) -> dict:
        """The kept steps against the reference's steps from the same
        states on the same target."""
        return self.numbers([(self.port_result(k),
                              self.ref_result(self.reference(k), k))
                             for k in self.kept])

    def control(self) -> dict:
        """The reference in bfloat16 in the program's place, on the steps a
        run checks (a first fit of the port gives their states)."""
        self.setup()
        self.kept = []
        self.fit(keep=True)
        return self.numbers([(self.ref_result(self.reference(
            k, torch.bfloat16), k), self.ref_result(self.reference(k), k))
            for k in self.kept])

    def work(self, seed_sample: int) -> dict:
        """The traced window's least work: each stage's mean live steps per
        ray from the reference at its checked step's entering parameters,
        on a seeded sample of the frame's pixels, times the stage's steps
        in the window."""
        n = int(self.traffic["steps_sample"])
        h, w = self.config["height"], self.config["width"]
        rng = np.random.default_rng(seed_sample)
        ids = torch.as_tensor(rng.integers(h * w, size=n),
                              device=self.device)
        per_stage = self.fits * self.per
        steps_per_ray = []
        for k in self.kept:
            params = [torch.tensor(x, dtype=torch.float32, device=self.device)
                      for x in k.params]
            steps_per_ray.append(inverse.mean_steps(
                self.fit_ref, params, ids,
                self.stages[k.stage]["march_steps"]))
        marched = per_stage * h * w * sum(steps_per_ray)
        return {"steps": per_stage * len(self.stages),
                "march_ops": inverse_counts.march_ops(marched),
                "march_bytes": inverse_counts.march_bytes(
                    per_stage * len(self.stages), h * w),
                "grad_ops": inverse_counts.grad_ops(marched),
                "grad_bytes": sum(
                    inverse_counts.grad_bytes(per_stage, h * w, s)
                    for s in steps_per_ray),
                "steps_per_ray": steps_per_ray}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / den if den > 0 else (
        0.0 if np.array_equal(got, want) else np.inf)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# The name benchmark/control.py asks a driver module for.
Frames = Fits


def run(spec) -> dict:
    from benchmark import session

    return session.run(spec, Fits(spec))
