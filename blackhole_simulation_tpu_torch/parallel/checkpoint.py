"""Checkpoint and resume of the inverse optimizer, on one device.

Counterpart of ``blackhole_simulation_tpu/parallel/checkpoint.py``
without Orbax: the port writes the JAX package's fallback format, one
``.npz`` of the flattened leaves named ``leaf_{i}``, so it reads what the
JAX package writes on that route and the JAX package reads what it
writes. Leaves are flattened in ``jax.tree_util``'s order over tuples,
lists, dicts (by sorted key), dataclasses (by field) and tensors or
arrays; ``None`` is an empty subtree with no leaf, as in ``jax.tree_util``,
and comes back as ``None``. The FD step's state ``(vec, (m, v, t))`` has
the same four leaves in the same order in both packages.

``save_checkpoint(path, tree)`` / ``load_checkpoint(path, like)``
round-trip a tree bit for bit, and put the loaded leaves on ``like``'s
devices and dtypes; ``CheckpointManager`` keeps step-indexed checkpoints
(``step_{step:08d}.npz``) with retention.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order
    (``None`` has none)."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (an iterator or a
    list, consumed in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return build(like)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_checkpoint(path: str, tree) -> str:
    """Save a tree of tensors as ``path + ".npz"`` (written to a temporary
    name, then renamed, so an interrupted save leaves no torn file);
    returns that path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    leaves = {f"leaf_{i}": _to_numpy(x)
              for i, x in enumerate(tree_leaves(tree))}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **leaves)
    os.replace(tmp, path + ".npz")
    return path + ".npz"


def load_checkpoint(path: str, like):
    """Load a checkpoint saved by ``save_checkpoint`` (or the JAX package's
    npz route). ``like`` gives the tree's structure, and each leaf's device
    and dtype where it is a tensor."""
    path = os.path.abspath(path)
    npz = path if path.endswith(".npz") else path + ".npz"
    flat = tree_leaves(like)
    with np.load(npz) as data:
        if len(data.files) != len(flat):
            raise ValueError(f"{npz} holds {len(data.files)} leaves, the "
                             f"template {len(flat)}")
        leaves = [data[f"leaf_{i}"] for i in range(len(flat))]
    out = [torch.from_numpy(v).to(device=ref.device, dtype=ref.dtype)
           if isinstance(ref, torch.Tensor) else v
           for v, ref in zip(leaves, flat)]
    return tree_unflatten(like, out)


class CheckpointManager:
    """Step-indexed checkpoints with retention: resume an interrupted
    inverse optimization at its latest step."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)(?:\.npz)?", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(set(out))

    def save(self, step: int, tree) -> str:
        path = save_checkpoint(self._step_path(step), tree)
        self._retain()
        return path

    def restore_latest(self, like):
        """(step, tree) of the latest checkpoint, or (None, None)."""
        steps = self.steps()
        if not steps:
            return None, None
        step = steps[-1]
        return step, load_checkpoint(self._step_path(step), like)

    def _retain(self) -> None:
        for old in self.steps()[: -self.keep] if self.keep > 0 else []:
            p = self._step_path(old) + ".npz"
            if os.path.exists(p):
                os.remove(p)
