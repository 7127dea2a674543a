"""Atomic, optionally asynchronous checkpoints in the reference's on-disk
format (the port of ``repro/train/checkpoint.py``).

Layout: ``<dir>/step_{N:010d}/`` holds one ``.npy`` per leaf, named by the
leaf's ``/``-joined tree path (other characters than ``[A-Za-z0-9_.-]``
become ``_``), and ``manifest.json`` (step; per key: file, shape, dtype).
A save writes ``step_N.tmp`` and renames it into place, so a crash mid-write
never leaves a partial checkpoint; only directories with a manifest count.
``keep`` newest checkpoints are kept.  A tree of the port's parameters (the
reference's stacked leaves) therefore crosses between the two packages in
both directions.

bfloat16 leaves: the reference saves them through ml_dtypes (an ``.npy``
of 2-byte voids) under manifest dtype ``"bfloat16"``.  The port writes their
16 bits as ``uint16`` under the same manifest dtype and reads either form
back as ``torch.bfloat16``.  An int leaf (the train state's host ``step``)
is written as an int32 scalar, as the reference's int32 step array is, and
read back as an int.

Sharded trees: a DTensor leaf is saved as its full value, in the same
format, so the files are byte-identical to an unsharded save.  Every rank
takes part in the gather (``full_tensor()`` is a collective) and rank 0
writes; a blocking save ends with a barrier, so every rank may read the
checkpoint when it returns.  ``restore(..., shardings=)`` places each leaf
with its ``(mesh, placements)`` (``distributed.sharding.spec_tree_sharding``),
so a checkpoint restores onto another mesh than the one that saved it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import full_value, is_dtensor
from repro_torch.tree import tree_items, tree_unflatten


def _host(leaf):
    """(numpy array, manifest dtype) of one leaf, copied off its device (a
    DTensor's full value)."""
    if isinstance(leaf, torch.Tensor):
        t = full_value(leaf.detach()).cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().copy(), "bfloat16"
        arr = t.numpy().copy()
    elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: Optional[bool] = None):
        """Copies every leaf to the host before returning (the caller may
        update its tensors in place at once), then writes them, in a thread
        when asynchronous."""
        self.wait()  # serialize with any in-flight async save
        items = list(tree_items(tree))
        sharded = any(is_dtensor(leaf) for _, leaf in items)
        # every rank gathers a sharded tree (a collective); rank 0 alone writes
        host = {key: _host(leaf) for key, leaf in items} if sharded else None
        in_thread = blocking is False or (blocking is None and self.async_save)
        # a step already checkpointed (e.g. periodic + final collide) is skipped
        if (not sharded or torch.distributed.get_rank() == 0) \
                and step not in self.all_steps():
            if host is None:
                host = {key: _host(leaf) for key, leaf in items}
            if in_thread:
                self._thread = threading.Thread(target=self._write, args=(step, host),
                                                daemon=True)
                self._thread.start()
            else:
                self._write(step, host)
        if sharded and not in_thread:
            torch.distributed.barrier()

    def _write(self, step: int, host):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                       "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, device=None, shardings=None):
        """Restore into the structure of ``template`` (values ignored): a
        tensor leaf comes back as a tensor on ``device`` (by default the
        template leaf's device) in the file's dtype, an int leaf as an int.
        ``shardings``, a tree of ``(mesh, placements)`` (or ``None``) leaves
        in the template's structure, makes each tensor a DTensor placed so;
        every rank of the mesh must call it.  Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)

        placed = dict(tree_items(shardings)) if shardings is not None else {}

        def load(key, leaf):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(path, meta["file"]))
            if isinstance(leaf, int):
                return int(arr)
            dev = device if device is not None else getattr(leaf, "device", "cpu")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
            else:
                t = torch.from_numpy(arr).to(dev)
            if placed.get(key) is None:
                return t
            from torch.distributed.tensor import distribute_tensor

            mesh, pl = placed[key]
            return distribute_tensor(t, mesh, pl)

        return tree_unflatten(template, [load(k, l) for k, l in tree_items(template)]), step



__all__ = ["CheckpointManager"]
