"""Checkpointing: atomic, async (the counterpart of ``repro.ckpt``).

Layout (one directory per step)::

    <root>/step_00000100/
        manifest.json          tree paths, shapes, dtypes, step, extras
        leaf_00000.npz         one file per tree leaf
        ...
        COMMIT                 written LAST — restore ignores dirs without it

Fault-tolerance contract, as in the JAX package:

* atomicity: data is written into ``<dir>.tmp`` and renamed; the COMMIT
  marker is created only after every leaf file is fsync'd — a machine lost
  mid-write never corrupts the latest checkpoint,
* ``find_latest`` returns the newest committed step (auto-resume),
* async mode: the device→host copy of every leaf happens before ``save``
  returns, file IO on a background thread; ``wait()`` joins before the next
  save.  The copy matters more here than in JAX: the port's optimizer
  updates parameters and state in place, so the next step would change a
  tensor the thread is still writing.

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern (uint16)
and the manifest records ``"bfloat16"``; ``load`` views the bits back.
Leaves come back on the device of the target tree's leaves.

Sharded trees (one process per rank, ``repro_torch.distributed``): given
``shardings`` (a tree of ``NamedSharding`` matching the tree), ``save``
gathers each leaf from the ranks and rank 0 writes it, in the same on-disk
format; ``load`` cuts each full leaf to this rank's shard on the mesh it is
given, which need not be the mesh that saved it (an elastic restart).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] of a nested dict, paths joined with '/'."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flatten_with_paths(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _to_host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(numpy array, dtype name) of a copy of ``leaf`` on the host."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.astype(dtype, copy=False))
    return t.to(device)


def save_checkpoint(root: str, step: int, tree, extras: Optional[dict] = None,
                    async_write: bool = False, shardings=None):
    """Returns a handle with ``.wait()`` (a no-op when synchronous).  With
    ``shardings`` every rank calls it: each leaf is gathered from its
    shards, rank 0 writes, and ``.wait()`` is also a barrier of the
    ranks."""
    flat = _flatten_with_paths(tree)
    writer = True
    if shardings is not None:
        from ..distributed.collectives import gather_full
        writer = dist.get_rank() == 0
        by_path = dict(_flatten_with_paths(shardings))
        full = [gather_full(leaf.detach(), by_path[path].spec,
                            by_path[path].mesh) for path, leaf in flat]
        flat = [(path, t) for (path, _), t in zip(flat, full)]
    host = [(path, *_to_host(leaf)) for path, leaf in flat] if writer \
        else []

    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"

    def _write():
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "extras": extras or {}, "leaves": []}
        for i, (path, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npz"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.savez(f, data=arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append(
                {"path": path, "file": fname,
                 "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # COMMIT written after the atomic rename of the full directory
        with open(os.path.join(final, "COMMIT"), "w") as f:
            f.write("ok")
            f.flush()
            os.fsync(f.fileno())

    barrier = dist.barrier if shardings is not None else (lambda: None)
    if not writer:
        class Peer:
            def wait(self):
                barrier()
        return Peer()

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()

        class Handle:
            def wait(self):
                t.join()
                barrier()
        return Handle()

    _write()

    class Done:
        def wait(self):
            barrier()
    return Done()


def find_latest(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "COMMIT")):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
    return max(steps) if steps else None


def load_checkpoint(root: str, step: int, target_tree, shardings=None):
    """Restore into the structure of ``target_tree``; each leaf goes to the
    device of the target's leaf.  Returns (tree, manifest).

    ``shardings``: a matching tree of ``NamedSharding`` on the NEW mesh
    (an elastic, resharded restart): each leaf comes back as this rank's
    shard of it, on the mesh's device.  The target's leaves then have the
    full shapes (``models.model.param_specs``' meta tensors) or this
    rank's shard shapes (a live tree)."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    shard_of = dict(_flatten_with_paths(shardings)) if shardings else {}
    restored = {}
    for path, node in _flatten_with_paths(target_tree):
        sh = shard_of.get(path)
        entry = by_path.get(path)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        arr = np.load(os.path.join(d, entry["file"]))["data"]
        if sh is None:
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"{path}: shape {arr.shape} != "
                                 f"{tuple(node.shape)}")
            restored[path] = _from_host(arr, entry["dtype"], node.device)
            continue
        from ..distributed.collectives import local_shard, shard_shape
        if tuple(node.shape) not in (tuple(arr.shape), shard_shape(
                arr.shape, sh.spec, sh.mesh)):
            raise ValueError(f"{path}: shape {arr.shape} (its shard "
                             f"{shard_shape(arr.shape, sh.spec, sh.mesh)}) "
                             f"!= {tuple(node.shape)}")
        full = _from_host(arr, entry["dtype"], "cpu")
        restored[path] = local_shard(full, sh.spec, sh.mesh).to(
            sh.mesh.device, copy=True)

    def rebuild(node, prefix):
        if isinstance(node, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in node.items()}
        return restored[prefix[:-1]]

    return rebuild(target_tree, ""), manifest


class CheckpointManager:
    """Keeps the last ``keep`` committed checkpoints; async by default."""

    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = root
        self.keep = keep
        self.async_write = async_write
        self._pending = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, tree, extras: Optional[dict] = None,
             shardings=None):
        self.wait()
        self._pending = save_checkpoint(self.root, step, tree, extras,
                                        async_write=self.async_write,
                                        shardings=shardings)
        self._gc()
        return self._pending

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

    def latest(self) -> Optional[int]:
        return find_latest(self.root)

    def restore_latest(self, target_tree, shardings=None):
        self.wait()
        step = self.latest()
        if step is None:
            return None
        tree, manifest = load_checkpoint(self.root, step, target_tree,
                                         shardings)
        return step, tree, manifest

    def _gc(self):
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.root, n, "COMMIT")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
