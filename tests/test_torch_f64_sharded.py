"""The sharded render under autograd against the JAX package's, on the CPU.

``torch.autograd`` of the mean of ``render_sharded(scene, mesh, dtype=...)``
over the scene's seven leaves (mass, spin, the camera's r, theta, phi, fov,
roll), in worlds of 2 and 3 ranks (spawned gloo processes, as
tests/test_torch_parallel.py runs them) and in the parent's world of one,
against ``jax.grad`` of JAX's ``render_sharded`` on a CPU mesh of as many
devices (conftest's 8 virtual ones), jitted in a child process without
fused multiply-adds (tests/test_torch_render_ad.py's ``JaxChild``).

The scene: tests/test_torch_render_ad.py's analytic one (12x8, 48 steps,
spin 0.7) with the tone map's bloom over the whole frame (threshold 0,
exposure 3), so that no pixel is exactly black (checked on JAX's image):
the tone map's x^(1/2.2) has an infinite derivative at 0, and both
packages' gradients are NaN wherever a frame has such a pixel, which the
same scene without the bloom shows (ROADMAP Queue 3 item 6). Bars: every
rank's gradients identical; against JAX rel 1e-7 (+1e-12) in float64
(worlds 2 and 3) and tests/test_torch_render_ad.py's 5e-3 (+1e-6) in
float32 (world 2). About 290 s under the suite's six workers: the child's
four jitted compiles of JAX's sharded gradient (~170 s alone) and the
gloo worlds.
"""

import dataclasses as dc
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from blackhole_simulation_tpu.parallel.render import (
    render_sharded as j_render_sharded,
)
from blackhole_simulation_tpu_torch.parallel import make_mesh, render_sharded
from blackhole_simulation_tpu_torch.parallel.render import single_device_twin
from blackhole_simulation_tpu_torch.render.pipeline import render
from test_torch_parallel import spawn_worlds
from test_torch_render_ad import LEAVES, JaxChild, _j_leaves, scenes

torch.set_num_threads(1)

F64 = torch.float64
BLOOM = dict(exposure=3.0, bloom_threshold=0.0)
# (scene, dtype) cases by world; "dark" keeps the default post (black
# pixels)
CASES = {2: (("bloom", "float64"), ("bloom", "float32"), ("dark", "float64")),
         3: (("bloom", "float64"),)}


def case_scenes(name):
    js, ts, _ = scenes("analytic")
    if name == "bloom":
        js = dc.replace(js, post=dc.replace(js.post, **BLOOM))
        ts = dc.replace(ts, post=dc.replace(ts.post, **BLOOM))
    return js, ts


def port_grads(scene, mesh, dtype):
    """The mean sharded image's gradients in the seven leaves (float64
    tensors holding the scene's numbers), and the image."""
    t = lambda v: torch.tensor(float(v), dtype=F64, requires_grad=True)
    cam = scene.camera
    leaves = [t(scene.bh.mass), t(scene.bh.spin)] + [t(getattr(cam, k))
                                                     for k in LEAVES[2:]]
    sc = dc.replace(
        scene, bh=dc.replace(scene.bh, mass=leaves[0], spin=leaves[1]),
        camera=dc.replace(cam, **dict(zip(LEAVES[2:], leaves[2:]))))
    img = (render_sharded(sc, mesh, dtype=dtype) if mesh is not None
           else render(single_device_twin(sc), device="cpu", dtype=dtype))
    grads = torch.autograd.grad(img.mean(), leaves)
    return [float(g) for g in grads], img.detach()


def _worker(rank, world, directory):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{directory}/init",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device="cpu")
        out = {}
        for name, dt in CASES[world]:
            grads, img = port_grads(case_scenes(name)[1], mesh,
                                    getattr(torch, dt))
            out[f"{name}_{dt}"] = {"grads": grads,
                                   "dtype": str(img.dtype).split(".")[-1],
                                   "img": img.numpy().tolist()}
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def child_main():
    from blackhole_simulation_tpu.parallel.mesh import make_mesh as j_mesh

    out = {}
    for n, cases in CASES.items():
        mesh = j_mesh(n)
        for name, dt in cases:
            js, _ = case_scenes(name)
            dtype = getattr(jnp, dt)
            img = j_render_sharded(js, mesh, dtype=dtype)
            loss = lambda s: jnp.mean(j_render_sharded(s, mesh,
                                                       dtype=dtype))
            out[f"{n}_{name}_{dt}"] = {
                "grads": _j_leaves(jax.jit(jax.grad(loss))(js)),
                "black_pixels": int(np.sum(np.asarray(img) == 0.0)),
                "dtype": str(img.dtype)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    child = JaxChild(__file__)
    try:
        dirs = {n: tmp_path_factory.mktemp(f"world{n}") for n in (2, 3)}
        spawn_worlds(_worker, dirs)
        ranks = {}
        for n, d in dirs.items():
            ranks[n] = []
            for r in range(n):
                with open(d / f"rank{r}.json") as f:
                    ranks[n].append(json.load(f))
        return ranks, child.result()
    finally:
        child.close()


def _close(got, want, dt):
    rel, floor = (1e-7, 1e-12) if dt == "float64" else (5e-3, 1e-6)
    return all(abs(g - w) <= rel * abs(w) + floor for g, w in zip(got, want))


@pytest.mark.parametrize("world, dt", [(2, "float64"), (3, "float64"),
                                       (2, "float32")])
def test_sharded_gradients_match_jax(results, world, dt):
    ranks, ref = results
    key = f"bloom_{dt}"
    jref = ref[f"{world}_{key}"]
    assert jref["black_pixels"] == 0 and jref["dtype"] == dt
    got = [rk[key]["grads"] for rk in ranks[world]]
    assert all(g == got[0] for g in got[1:]), got
    assert all(rk[key]["dtype"] == dt for rk in ranks[world])
    assert all(math.isfinite(g) for g in got[0])
    assert _close(got[0], jref["grads"], dt), (got[0], jref["grads"])


@pytest.mark.parametrize("world", [2])
def test_black_pixels_give_nan_in_both(results, world):
    ranks, ref = results
    jref = ref[f"{world}_dark_float64"]
    assert jref["black_pixels"] > 0
    assert any(math.isnan(g) for g in jref["grads"])
    for rk in ranks[world]:
        assert any(math.isnan(g) for g in rk["dark_float64"]["grads"])


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_world_of_one_is_the_single_device_render(results, dt):
    """The parent's one-device mesh: the sharded render's image and
    gradients are the single-device twin's ``render()``, bit for bit; the
    worlds' images equal it within the CPU's shard-tail rounding."""
    _, ts = case_scenes("bloom")
    dtype = getattr(torch, dt)
    g1, img1 = port_grads(ts, make_mesh(device="cpu"), dtype)
    g0, img0 = port_grads(ts, None, dtype)
    assert torch.equal(img1, img0) and g1 == g0
    ranks, _ = results
    for n, cases in CASES.items():
        if ("bloom", dt) in cases:
            img = np.asarray(ranks[n][0][f"bloom_{dt}"]["img"])
            np.testing.assert_allclose(img, img0.numpy(), atol=5e-4)


if __name__ == "__main__":
    # The child process of the results fixture: one JSON line.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(child_main()))
