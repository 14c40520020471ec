"""The port's device mesh, sharded render and ``cli sweep`` on the CPU.

Worlds of 2 and 3 ranks (``torch.distributed`` with gloo, file init) are
spawned once for the module and run every sharded case; the results come
back through files in a temporary directory and each case is its own test.
The parent process is the world of 1 (a one-device mesh, no group).

Bars (tests/test_parallel.py's, and the staged ones of
tests/test_torch_march.py):

* world 2 and 3 against world 1: bit-equal with ``use_pallas``, where
  every shard is padded to whole tiles of ``TILE`` rays; otherwise JAX's
  robust bar, (per-pixel max |d| < 5e-4) on more than 99.5% of the pixels
  and max |d| < 5e-2 (the CPU's vectorised transcendentals round a shard's
  tail elements apart from its body);
* against JAX: JAX's ``render_sharded`` run op by op is too slow here
  (``shard_map`` dispatches every operation per device); its shard body is
  the staged render's, so the op-by-op reference is JAX's ``render`` of the
  same scene (``use_pallas`` off), at p99 |d| < 1e-4 and mean < 1e-5 for
  the analytic disk, 2e-2 / 1e-3 for the spectral one. JAX's jitted
  ``render_sharded`` on the 8-device mesh (conftest) is then no farther
  from the port than from its own op-by-op render;
* the hosts x chips mesh against the flat one: atol 5e-5;
* ``refine_band`` is ignored by the sharded render (ADVICE item 3): a scene
  with ``refine_band=0.6`` renders bit-equal to the same with 0.
"""

import contextlib
import io
import json
import math
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from blackhole_simulation_tpu_torch.app import cli as tcli
from blackhole_simulation_tpu_torch.parallel import (
    gather_image,
    initialize_multihost,
    local_device_count,
    make_host_chip_mesh,
    make_mesh,
    render_sharded,
    shard_rays_spec,
)
from blackhole_simulation_tpu_torch.parallel import mesh as tmesh
from blackhole_simulation_tpu_torch.render import Camera, Features, MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import Scene

torch.set_num_threads(1)

THETA = math.pi / 2 - 0.25
CFG = dict(max_steps=48, shadow_precull=True, far_step_cap_rate=0.4,
           far_boost_radius=20.0, midpoint_iters=1, remat_every=0)
SWEEP = ["--device", "cpu", "sweep", "--frames", "2", "--width", "24",
         "--height", "16", "--set", "quality=low"]
WORLD_TIMEOUT = 600


def _scene(width=32, height=16, spectral=False, use_pallas=False, **cfg):
    cam = Camera.create(r=30.0, theta=THETA, fov=0.5, width=width,
                        height=height)
    return Scene.create(mass=1.0, spin=0.9, camera=cam,
                        march_cfg=MarchConfig(**{**CFG, **cfg},
                                              use_pallas=use_pallas),
                        features=Features(spectral_lut=spectral))


# (scene, n_samples) of each sharded render case.
CASES = {
    f"{name}_{order}": (_scene(**kw, use_pallas=order == "block"), n)
    for name, kw, n in (("analytic", {}, 1),
                        ("spectral", {"spectral": True}, 1),
                        ("padding", {"width": 30, "height": 11}, 1),
                        ("samples3", {}, 3))
    for order in ("block", "rowmajor")
}
REFINED = _scene(use_pallas=True, refine_band=0.6)


def _renders(world):
    """Every sharded render case on this process's mesh."""
    mesh = make_mesh(device="cpu")
    assert mesh.size == world
    out = {k: render_sharded(s, mesh, n).numpy() for k, (s, n) in CASES.items()}
    out["refined"] = render_sharded(REFINED, mesh).numpy()
    chips = make_host_chip_mesh(device="cpu")
    out["hostchip_shape"] = np.asarray(chips.shape)
    out["hostchip"] = render_sharded(CASES["analytic_rowmajor"][0],
                                     chips).numpy()
    return out


def _sweep(path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(SWEEP + ["--out", path]) == 0
    return buf.getvalue()


def _worker(rank, world, directory):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    dist.init_process_group("gloo", init_method=f"file://{directory}/init",
                            rank=rank, world_size=world)
    try:
        out = _renders(world)
        out["sweep_stdout"] = np.asarray(
            _sweep(os.path.join(directory, "sweep.npz")))
        np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_worlds(fn, dirs, timeout=WORLD_TIMEOUT):
    """Run ``fn(rank, world, directory)`` in a spawned world of each size
    of ``dirs`` ({world: directory}), all at once; fail loudly if a rank
    raises (the others are then ended) or the worlds outlive ``timeout``
    seconds."""
    ctxs = [mp.start_processes(fn, args=(n, str(d)), nprocs=n, join=False,
                               start_method="spawn")
            for n, d in dirs.items()]
    deadline = time.monotonic() + timeout
    for ctx in ctxs:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                for c in ctxs:
                    for p in c.processes:
                        p.kill()
                pytest.fail(f"the spawned worlds outlived {timeout} s")


def _load(directory, world):
    ranks = []
    for r in range(world):
        with np.load(directory / f"rank{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
    return ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{1: the parent's results, 2 and 3: rank 0's}, after checking that
    every rank holds the same images."""
    dirs = {n: tmp_path_factory.mktemp(f"world{n}") for n in (2, 3)}
    spawn_worlds(_worker, dirs)
    one = _renders(1)
    one["sweep_stdout"] = np.asarray(_sweep(str(dirs[2] / "sweep1.npz")))
    out = {1: one}
    for n, d in dirs.items():
        ranks = _load(d, n)
        for other in ranks[1:]:
            for k in CASES:
                assert np.array_equal(other[k], ranks[0][k]), (n, k)
            assert str(other["sweep_stdout"]) == ""
        out[n] = ranks[0]
        with np.load(d / "sweep.npz") as f:
            out[n]["sweep_frames"] = f["frames"]
    with np.load(dirs[2] / "sweep1.npz") as f:
        out[1]["sweep_frames"] = f["frames"]
    return out


def _robust(a, b):
    diff = np.abs(a - b).max(axis=2)
    assert (diff < 5e-4).mean() > 0.995, (diff < 5e-4).mean()
    assert diff.max() < 5e-2, diff.max()


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_matches_world_of_one(worlds, world, case):
    got, ref = worlds[world][case], worlds[1][case]
    scene = CASES[case][0]
    assert got.shape == (scene.camera.height, scene.camera.width, 3)
    assert np.isfinite(got).all()
    if case.endswith("block"):
        assert np.array_equal(got, ref)
    else:
        _robust(got, ref)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_refine_band_is_ignored(worlds, world):
    """ADVICE item 3, reproduced: the sharded render never refines."""
    assert np.array_equal(worlds[world]["refined"],
                          worlds[world]["analytic_block"])


@pytest.mark.parametrize("world", [1, 2, 3])
def test_host_chip_mesh_matches_flat(worlds, world):
    assert tuple(worlds[world]["hostchip_shape"]) == (1, world)
    np.testing.assert_allclose(worlds[world]["hostchip"],
                               worlds[world]["analytic_rowmajor"], atol=5e-5)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_sweep_npz_and_json(worlds, world):
    """tests/test_app.py::test_sweep_tiny on the port: the npz volume and
    JAX's JSON line, with the mesh's size; rank 0 alone writes and prints."""
    frames = worlds[world]["sweep_frames"]
    assert frames.shape == (2, 16, 24, 3) and np.isfinite(frames).all()
    line = json.loads(str(worlds[world]["sweep_stdout"]).strip()
                      .splitlines()[-1])
    assert sorted(line) == ["devices", "frames", "mrays_per_s", "out",
                            "shape"]
    assert line["devices"] == world and line["frames"] == 2
    assert line["shape"] == [2, 16, 24, 3] and line["mrays_per_s"] > 0
    if world > 1:
        _robust(frames.reshape(-1, 24, 3),
                worlds[1]["sweep_frames"].reshape(-1, 24, 3))


# -- against the JAX package -------------------------------------------------

@pytest.fixture(scope="module")
def jax_refs():
    """JAX's staged render op by op, and its jitted ``render_sharded`` on the
    8-device mesh, of the analytic and spectral scenes."""
    import jax
    import jax.numpy as jnp

    from blackhole_simulation_tpu.parallel import make_mesh as j_make_mesh
    from blackhole_simulation_tpu.parallel import (
        render_sharded as j_render_sharded,
    )
    from blackhole_simulation_tpu.render import Camera as JCamera
    from blackhole_simulation_tpu.render import Features as JFeatures
    from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
    from blackhole_simulation_tpu.render import Scene as JScene
    from blackhole_simulation_tpu.render import render as j_render

    out = {}
    for disk in ("analytic", "spectral"):
        cam = JCamera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                             width=32, height=16)
        js = JScene.create(mass=1.0, spin=0.9, camera=cam,
                           march_cfg=JMarchConfig(**CFG),
                           features=JFeatures(spectral_lut=disk == "spectral"))
        with jax.disable_jit():
            eager = np.asarray(j_render(js))
        jitted = np.asarray(j_render_sharded(js, j_make_mesh(8)))
        out[disk] = eager, jitted
    return out


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("order", ["block", "rowmajor"])
@pytest.mark.parametrize("disk", ["analytic", "spectral"])
def test_sharded_matches_jax(worlds, jax_refs, disk, order, world):
    got = worlds[world][f"{disk}_{order}"]
    eager, jitted = jax_refs[disk]
    d = np.abs(got - eager)
    p99, mean = (2e-2, 1e-3) if disk == "spectral" else (1e-4, 1e-5)
    assert np.percentile(d, 99) < p99, np.percentile(d, 99)
    assert d.mean() < mean, d.mean()
    # JAX's own render_sharded, compiled: its rounding moves it as far from
    # the port as from JAX's op-by-op render, no farther.
    assert np.abs(got - jitted).max() <= np.abs(eager - jitted).max() + 1e-6


# -- the mesh's API ------------------------------------------------------------

def test_gather_image_is_the_identity():
    x = torch.arange(12.0).reshape(2, 2, 3)
    assert gather_image(x) is x


def test_one_process_mesh():
    mesh = make_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.shape) == (None, 1, 0, (1,))
    assert mesh.device == torch.device("cpu") and mesh.backend is None
    assert make_mesh(1, device="cpu").size == 1
    chips = make_host_chip_mesh(device="cpu")
    assert chips.axis_names == ("hosts", "chips") and chips.shape == (1, 1)
    spec = shard_rays_spec(mesh)
    assert spec.bounds(10) == (0, 10)
    assert local_device_count() >= 1


def test_make_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="not initialised"):
        make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="one process per device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="one process per device"):
        make_host_chip_mesh(device="cuda")
    assert make_mesh(device="cpu").size == 1


def test_no_card_is_never_a_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_initialize_multihost_single_process_is_a_no_op():
    initialize_multihost()
    initialize_multihost(num_processes=1)
    assert not dist.is_initialized()


def test_shard_bounds():
    from blackhole_simulation_tpu_torch.parallel.render import RaySharding

    mesh3 = tmesh.Mesh(None, ("devices",), (3,), 2, torch.device("cpu"), None)
    assert shard_rays_spec(mesh3) == RaySharding(3, 2)
    assert RaySharding(3, 2).bounds(12) == (8, 12)
    x = torch.arange(24).reshape(2, 12)
    assert RaySharding(3, 1).shard(x).tolist() == [[4, 5, 6, 7],
                                                   [16, 17, 18, 19]]
    with pytest.raises(ValueError):
        RaySharding(3, 0).bounds(10)


def test_world_mesh_collectives(tmp_path):
    """A group of one (gloo) in this process: the mesh spans it and the
    collectives run."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device="cpu")
        assert mesh.group is not None and mesh.backend == "gloo"
        assert mesh.size == 1 and mesh.rank == 0
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(tmesh.all_gather(mesh, x), x)
        y = tmesh.all_reduce_sum(mesh, x)
        assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
        with pytest.raises(ValueError, match="world of 1"):
            make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
