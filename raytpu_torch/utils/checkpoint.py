"""Checkpoint / resume of a fit's scene (the counterpart of
raytpu.utils.checkpoint).

The file is raytpu's layout: an .npz of `leaf_{i}` arrays in the order of
JAX's tree_leaves of a raytpu Scene (scene_leaves here), written through a
temporary file and an atomic rename.  A scene either package saves, the
other loads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raytpu_torch.scene import Scene, scene_from_leaves, scene_leaves


def save_checkpoint(path: str, scene: Scene) -> None:
    """Atomically write the scene's leaves to `path` (.npz)."""
    arrays = {f"leaf_{i}": t.detach().cpu().numpy()
              for i, t in enumerate(scene_leaves(scene))}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, like: Scene) -> Scene:
    """Restore a scene saved by either package's save_checkpoint, with the
    shapes, dtypes and device of `like`."""
    leaves = scene_leaves(like)
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves, "
                             f"expected {len(leaves)}")
        restored = [data[f"leaf_{i}"] for i in range(len(leaves))]
    out = []
    for r, t in zip(restored, leaves):
        if tuple(r.shape) != tuple(t.shape):
            raise ValueError(f"leaf shape mismatch: {r.shape} vs {tuple(t.shape)}")
        out.append(torch.tensor(r, dtype=t.dtype, device=t.device))
    return scene_from_leaves(out)
