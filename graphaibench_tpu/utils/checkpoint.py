"""Training checkpoint/resume.

The reference has NO weight save/load (SURVEY.md §5 — models live and
die in one process); resuming long training runs needs it, so this adds
it: the leaves of any pytree of arrays in one numpy ``.npz`` per step,
restored into the structure of a template pytree."""

from __future__ import annotations

import os
from typing import Any

import jax
import numpy as np


def _npz_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.npz")


def save_checkpoint(path: str, state: Any, *, step: int = 0) -> str:
    """Save a pytree to ``path`` (directory). Returns the file written."""
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree.leaves(state)
    target = _npz_path(path, step)
    np.savez(target, *[np.asarray(leaf) for leaf in leaves])
    return target


def restore_checkpoint(path: str, like: Any, *, step: int = 0) -> Any:
    """Restore into the structure of ``like``."""
    import jax.numpy as jnp

    leaves, treedef = jax.tree.flatten(like)
    with np.load(_npz_path(path, step)) as npz:
        if len(npz.files) != len(leaves):
            raise ValueError(
                f"checkpoint holds {len(npz.files)} arrays; the template "
                f"pytree has {len(leaves)} leaves")
        new = [jnp.asarray(npz[f"arr_{i}"]) for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, new)
