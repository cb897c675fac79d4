"""Atomic checkpointing with resume, in the JAX package's on-disk format.

Layout:  <dir>/step_<N>/
           manifest.json       {step, num_leaves, treedef, time, shapes, dtypes}
           arr_<i>.npy         one file per leaf, in ``jax.tree.flatten``'s
                               leaf order (``repro_torch.tree``)
         <dir>/LATEST          text file naming the newest complete step

Writes go to a temporary directory, renamed into place only after the
manifest lands, so a crash mid-write never corrupts the latest
checkpoint (a restart reads LATEST, or the newest complete step).  The
arrays and leaf order are the JAX package's, so either package restores
the other's checkpoints.  ``restore`` puts each array on the device of
the matching leaf of the target tree, in that leaf's dtype.

Sharded trees: ``save`` writes a DTensor leaf as its full array
(``full_tensor()``, a collective every rank calls; rank 0 writes, and
every rank waits for it), and ``restore(..., shardings)`` lays each
leaf out by the matching ``Sharding`` (a DTensor target leaf without
one keeps its own layout), so a checkpoint written from one mesh
restores onto another.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.distributed.actctx import is_dtensor
from repro_torch.tree import flatten, unflatten


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a live process group, or
    the only process."""
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def save(ckpt_dir: str | pathlib.Path, step: int, tree, keep: int = 3):
    leaves, spec = flatten(tree)
    if any(is_dtensor(t) for t in leaves):
        import torch.distributed as dist
        writer = _writer()
        arrays = []
        for leaf in leaves:             # every rank takes part in gathers
            full = leaf.full_tensor() if is_dtensor(leaf) else leaf
            if writer:
                arrays.append(_host(full))
        final = _write(ckpt_dir, step, spec, arrays, keep) if writer \
            else pathlib.Path(ckpt_dir) / f"step_{step}"
        dist.barrier()
        return final
    return _write(ckpt_dir, step, spec, [_host(leaf) for leaf in leaves],
                  keep)


def _write(ckpt_dir, step: int, spec, arrays: list, keep: int):
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp_step_{step}"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    meta = {"step": step, "num_leaves": len(arrays),
            "treedef": repr(spec), "time": time.time(),
            "shapes": [list(a.shape) for a in arrays],
            "dtypes": [str(a.dtype) for a in arrays]}
    for i, a in enumerate(arrays):
        np.save(tmp / f"arr_{i}.npy", a)
    (tmp / "manifest.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    (ckpt_dir / "LATEST").write_text(str(step))

    # retention
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return final


def latest_step(ckpt_dir: str | pathlib.Path):
    ckpt_dir = pathlib.Path(ckpt_dir)
    marker = ckpt_dir / "LATEST"
    if not marker.exists():
        return None
    step = int(marker.read_text().strip())
    if not (ckpt_dir / f"step_{step}" / "manifest.json").exists():
        # fall back to the newest complete step
        steps = sorted(
            int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
            if (p / "manifest.json").exists())
        return steps[-1] if steps else None
    return step


def restore(ckpt_dir: str | pathlib.Path, step: int, target_tree,
            shardings=None):
    """Load into the structure of ``target_tree`` (values replaced): each
    array goes to its target leaf's device and dtype, laid out on a
    mesh by the matching ``Sharding`` of ``shardings`` (a tree of the
    target's structure, laid out on a ``DeviceMesh`` over the live
    process group), or, without one, as a DTensor target leaf is."""
    ckpt_dir = pathlib.Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((ckpt_dir / "manifest.json").read_text())
    leaves, spec = flatten(target_tree)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, the "
                         f"target tree {len(leaves)}")
    shs = [None] * len(leaves) if shardings is None \
        else flatten(shardings)[0]
    meshes: dict = {}
    loaded = []
    for i, (leaf, sh) in enumerate(zip(leaves, shs)):
        a = np.load(ckpt_dir / f"arr_{i}.npy")
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape}, target "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)
        if sh is not None or is_dtensor(leaf):
            t = _lay_out(t, leaf, sh, meshes)
        loaded.append(t)
    return unflatten(spec, loaded)


def _lay_out(t, leaf, sh, meshes: dict):
    """The full tensor ``t`` placed as ``sh`` says (on a ``DeviceMesh``
    over the live group, made once a mesh) or as the DTensor ``leaf``
    is."""
    from repro_torch.models.params import place
    if sh is None:
        return place(t, leaf.device_mesh, leaf.placements)
    if sh.mesh not in meshes:
        from repro_torch.launch.mesh import device_mesh
        meshes[sh.mesh] = device_mesh(sh.mesh, t.device.type)
    return place(t, meshes[sh.mesh], sh.placements())
