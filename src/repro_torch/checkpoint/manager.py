"""Fault-tolerant checkpoints: counterpart of
``repro/checkpoint/manager.py``.  An npz of leaves and a JSON manifest a
step, visible only after an atomic rename, written by a background thread
that overlaps the next training step, with latest-step discovery and
garbage collection of old steps.

Layout:  <dir>/step_<N:08d>/
            manifest.json        paths, shapes, dtypes, step, extra
            shard_<host>.npz     this host's leaves (numpy arrays)
         <dir>/step_<N>.tmp_*    in-flight writes (ignored by discovery)

A tree is nested dicts (sorted keys) and lists; a path names its keys and
list indices (``blocks/0/attn/wq``).  Leaves are tensors (copied to the
host before ``save`` returns, so training may update them in place next)
or numpy arrays.  A bfloat16 tensor is stored as its raw 16 bits
(uint16) with the dtype name "bfloat16" in the manifest, and viewed back
on restore: no ``ml_dtypes`` is needed.  ``restore`` takes ``device=``.

On a rank mesh (``mesh=``, with ``layout=`` at ``save`` and ``restore``:
the tree's ``sharding.train.LeafShard``s, the reference's ``shardings=``)
the layout is still the reference's, "leaves stored unsharded per-host":
``save`` gathers each placed leaf whole, one leaf at a time, in rank
order, and rank 0 alone writes; ``restore`` slices each stored leaf onto
whatever mesh is current, so a checkpoint of one mesh resumes on another
or on one process, and the reverse.  A save or restore is a collective:
every rank calls it, and ``wait`` holds every rank until rank 0's write
is on disk.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import train as ST
from repro_torch.tree import flatten, path_str, unflatten


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array to store, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even of a CPU leaf: ``.cpu()`` returns that leaf itself,
        # which training would go on updating in place under the write
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, saved_dtype: str, like, device):
    """A stored array -> a leaf of ``like``'s kind and dtype: a tensor on
    ``device`` (default: like's device) or a numpy array."""
    if saved_dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device if device is None else device,
                    dtype=like.dtype)
    dt = np.asarray(like).dtype
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().astype(dt)


class CheckpointManager:
    def __init__(self, directory: str, host_id: int = 0, n_hosts: int = 1,
                 keep: int = 3, mesh=None):
        self.dir = directory
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.keep = keep
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- write --
    def save(self, step: int, tree, extra: Optional[dict] = None,
             blocking: bool = True, layout=None) -> None:
        """Copy every leaf to host memory now, then write to disk (in a
        background thread unless ``blocking``).  A failed write surfaces
        on the next ``wait()``.  ``layout``: ``tree``'s leaves are this
        rank's parts (a mesh); each is gathered whole first."""
        self.wait()                    # one write in flight at a time
        flat = flatten(tree)
        if layout is not None:
            shards = [sh for _, sh in flatten(layout)]
            host = []
            for (_, leaf), sh in zip(flat, shards):
                whole = ST.whole_leaf(leaf.detach(), sh)
                host.append(None if whole is None else _to_host(whole))
                del whole
            if not self.writer:
                if blocking:
                    self.wait()
                return
        else:
            host = [_to_host(leaf) for _, leaf in flat]
        manifest = {
            "step": step,
            "paths": [path_str(p) for p, _ in flat],
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [d for _, d in host],
            "n_hosts": self.n_hosts,
            "extra": extra or {},
        }
        arrays = [a for a, _ in host]

        def write():
            final = os.path.join(self.dir, f"step_{step:08d}")
            tmp = None
            try:
                # inside the try: a directory that cannot take the write
                # is reported on wait() too
                tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp_",
                                       dir=self.dir)
                np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                         **{str(i): a for i, a in enumerate(arrays)})
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)          # atomic visibility
                self._gc()
            except BaseException as e:          # surfaced on wait()
                self._error = e
                if tmp is not None:
                    shutil.rmtree(tmp, ignore_errors=True)

        if blocking:
            write()
            self.wait()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()
        if self.mesh is not None:
            # no rank reads on before rank 0's write is on disk
            dist.barrier(group=self.mesh.host_group)

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {err!r}")

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- read --
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d{8})", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None,
                device=None, strict_shapes: bool = True,
                layout=None) -> tuple:
        """Restore into the structure of ``tree_like`` (latest step by
        default).  Each leaf comes back in its ``tree_like`` counterpart's
        dtype: a tensor on ``device`` (default: that counterpart's
        device), or a numpy array.  A tree whose paths differ from the
        saved ones is refused.  ``strict_shapes=False`` lets a leaf whose
        saved shape differs pass through at the saved shape (the caller
        reshapes it, as ``restore_controller`` does across shard grids).
        ``layout``: ``tree_like`` holds this rank's parts (a mesh); each
        stored whole leaf is sliced to this rank's part.  Returns (tree,
        extra)."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = flatten(tree_like)
        want = [path_str(p) for p, _ in flat]
        if want != manifest["paths"]:
            raise ValueError("checkpoint tree mismatch: "
                             f"{set(want) ^ set(manifest['paths'])}")
        shards = ([sh for _, sh in flatten(layout)] if layout is not None
                  else [None] * len(flat))
        leaves = []
        with np.load(os.path.join(d, f"shard_{self.host_id}.npz")) as data:
            for i, (_, like) in enumerate(flat):
                arr = data[str(i)]
                if shards[i] is not None:
                    if tuple(arr.shape) != shards[i].whole:
                        raise ValueError(
                            f"shape mismatch at {want[i]}: {arr.shape} vs "
                            f"the whole leaf {shards[i].whole}")
                    arr = ST.take(arr, shards[i])
                if strict_shapes and tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"shape mismatch at {want[i]}: "
                                     f"{arr.shape} vs {tuple(like.shape)}")
                leaves.append(_from_host(arr, manifest["dtypes"][i], like,
                                         device))
        return unflatten(tree_like, leaves), manifest["extra"]
