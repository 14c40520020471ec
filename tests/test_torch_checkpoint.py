"""The port's single-device checkpoints (``parallel/checkpoint.py``): a
bit-exact round trip, retention, an FD inverse run through the CLI resumed
from its checkpoint against the uninterrupted run (bit for bit, 16x12 on
the CPU), and the JAX package's npz route read by the port and the port's
files read by the JAX package, on the FD driver's state."""

import dataclasses
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.parallel.train import (
    InverseParams as JInverseParams,
    fd_state_init as j_fd_state_init,
)
from blackhole_simulation_tpu_torch.app.cli import main
from blackhole_simulation_tpu_torch.parallel import checkpoint as tck
from blackhole_simulation_tpu_torch.parallel.train import (
    InverseParams,
    fd_state_init,
)

jck = importlib.import_module("blackhole_simulation_tpu.parallel.checkpoint")


@dataclasses.dataclass(frozen=True)
class _Pair:
    b: torch.Tensor
    a: torch.Tensor


def _tree():
    rng = np.random.default_rng(0)
    return (
        torch.from_numpy(rng.standard_normal(4).astype(np.float32)),
        {"z": torch.tensor(7, dtype=torch.int32),
         "y": [torch.from_numpy(rng.standard_normal((2, 3))),
               _Pair(b=torch.tensor([np.nan, -0.0, np.inf]),
                     a=torch.tensor([True, False]))]},
    )


def test_round_trip_bit_exact(tmp_path):
    tree = _tree()
    path = tck.save_checkpoint(str(tmp_path / "sub" / "ck"), tree)
    assert path.endswith("ck.npz") and os.path.exists(path)
    assert not any(p.name.endswith(".tmp.npz") for p in
                   (tmp_path / "sub").iterdir())
    like = tck.tree_unflatten(tree, [torch.zeros_like(x)
                                     for x in tck.tree_leaves(tree)])
    back = tck.load_checkpoint(str(tmp_path / "sub" / "ck"), like)
    a, b = tck.tree_leaves(tree), tck.tree_leaves(back)
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()
    assert isinstance(back[1]["y"][1], _Pair) and list(back[1]) == ["z", "y"]
    # dict leaves in sorted-key order, dataclass leaves in field order
    assert [tuple(x.shape) for x in a] == [(4,), (2, 3), (3,), (2,), ()]
    with pytest.raises(ValueError):
        tck.load_checkpoint(path, (like, torch.zeros(1)))


def test_retention_keeps_three(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))
    assert mgr.restore_latest((torch.zeros(2),)) == (None, None)
    for step in (1, 2, 5, 9, 12):
        mgr.save(step, (torch.full((2,), float(step)),))
    assert mgr.steps() == [5, 9, 12]
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "step_00000005.npz", "step_00000009.npz", "step_00000012.npz"]
    step, (x,) = mgr.restore_latest((torch.zeros(2),))
    assert step == 12 and x.tolist() == [12.0, 12.0]


class _Stop(Exception):
    pass


def test_fd_inverse_resumed_equals_uninterrupted(tmp_path, monkeypatch,
                                                 capsys):
    """``inverse --checkpoint-dir`` stopped after step 2 of 4 (the save of
    step 2 raises, as a kill would end the process) and resumed by a fresh
    ``main`` with the same arguments ends on the uninterrupted run's FD
    state bit for bit. (Resuming with another ``--steps`` would not: the
    cosine learning-rate schedule spans ``--steps``.)"""
    def run(directory):
        assert main(["--device", "cpu", "inverse", "--width", "16",
                     "--height", "12", "--steps", "4", "--set",
                     "quality=low", "--checkpoint-dir", directory]) == 0

    run(str(tmp_path / "a"))
    save = tck.CheckpointManager.save

    def save_then_stop(self, step, tree):
        out = save(self, step, tree)
        if step == 2:
            raise _Stop
        return out

    monkeypatch.setattr(tck.CheckpointManager, "save", save_then_stop)
    with pytest.raises(_Stop):
        run(str(tmp_path / "b"))
    monkeypatch.setattr(tck.CheckpointManager, "save", save)
    assert tck.CheckpointManager(str(tmp_path / "b")).steps() == [1, 2]
    run(str(tmp_path / "b"))
    assert "resumed from step 2" in capsys.readouterr().out
    with np.load(tmp_path / "a" / "step_00000004.npz") as a, \
            np.load(tmp_path / "b" / "step_00000004.npz") as b:
        assert a.files == b.files and len(a.files) == 4
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


def _jax_states():
    rng = np.random.default_rng(1)
    init = j_fd_state_init(JInverseParams.init(spin=0.6, theta_cam=1.2))
    moved = (jnp.asarray(rng.standard_normal(4).astype(np.float32)),
             (jnp.asarray(rng.standard_normal(4).astype(np.float32)),
              jnp.asarray(rng.uniform(0, 1, 4).astype(np.float32)),
              jnp.asarray(7, jnp.int32)))
    return {"init": init, "moved": moved}


@pytest.mark.parametrize("case", ["init", "moved"])
def test_loads_the_jax_npz_route(case, tmp_path, monkeypatch):
    """The JAX package writes through its npz route (Orbax off for this
    test only); the port loads the FD state onto its own template. The
    leaf order is the same: (vec, (m, v, t)). JAX's initial moments are
    float64 zeros (the package enables x64); they load as the port's
    float32 zeros."""
    monkeypatch.setattr(jck, "_HAVE_ORBAX", False)
    jstate = _jax_states()[case]
    path = jck.save_checkpoint(str(tmp_path / "j"), jstate)
    like = fd_state_init(InverseParams.init())
    got = tck.load_checkpoint(path, like)
    want = [np.asarray(x) for x in
            (jstate[0], jstate[1][0], jstate[1][1], jstate[1][2])]
    for g, w, ref in zip(tck.tree_leaves(got), want, tck.tree_leaves(like)):
        assert g.dtype == ref.dtype and g.shape == w.shape
        assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))
    # and the JAX package reads what the port writes
    tpath = tck.save_checkpoint(str(tmp_path / "t"), got)
    back = jck.load_checkpoint(tpath, jstate)
    for b, g in zip(jck.jax.tree_util.tree_leaves(back),
                    tck.tree_leaves(got)):
        assert np.array_equal(np.asarray(b), g.numpy())


def _none_trees():
    return {
        "opt_none": {"x": torch.zeros(3), "opt": None},
        "nested_none": (torch.zeros(2), None, {"b": 1.0, "a": None}),
    }


def _as_jax(tree):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_as_jax(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    return tree


@pytest.mark.parametrize("case", ["opt_none", "nested_none"])
def test_none_is_an_empty_subtree(case, tmp_path, monkeypatch):
    """``None`` holds no leaf, as in ``jax.tree_util``: the leaf count is
    JAX's, the tree round-trips with its ``None`` in place, and the
    ``leaf_{i}`` files equal the JAX package's npz route on the same
    tree."""
    tree = _none_trees()[case]
    jtree = _as_jax(tree)
    leaves = tck.tree_leaves(tree)
    assert len(leaves) == len(jck.jax.tree_util.tree_leaves(jtree))
    path = tck.save_checkpoint(str(tmp_path / "t"), tree)
    back = tck.load_checkpoint(path, tree)
    if case == "opt_none":
        assert back["opt"] is None and list(back) == ["x", "opt"]
        assert back["x"].numpy().tobytes() == tree["x"].numpy().tobytes()
    else:
        assert back[1] is None and back[2]["a"] is None
        assert back[0].numpy().tobytes() == tree[0].numpy().tobytes()
        assert float(back[2]["b"]) == 1.0
    monkeypatch.setattr(jck, "_HAVE_ORBAX", False)
    jpath = jck.save_checkpoint(str(tmp_path / "j"), jtree)
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes()
    jback = jck.load_checkpoint(path, jtree)
    assert (jck.jax.tree_util.tree_structure(jback)
            == jck.jax.tree_util.tree_structure(jtree))
