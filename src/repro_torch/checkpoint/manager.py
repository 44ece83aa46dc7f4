"""Checkpoints in the reference's npz + MANIFEST format.

The port of ``repro.checkpoint.manager.CheckpointManager``, reading and
writing the same layout, so a checkpoint written by either package
restores in the other:

    ckpt_dir/step_000000123/
        MANIFEST.json     # {"step", "leaves": [{"path", "key", "shape",
                          #   "dtype"}]}
        shard_0_0.npz     # one array per leaf, keyed "a<i>"
        COMMIT            # written last: marks the step complete

Leaves are keyed by the JAX ``keystr`` of their path in the saved tree
(``"[0]['units']['pos0']['wq']"`` for a leaf of the params in a
``(params, opt_state)`` pair), in the reference's flattening order
(tuples in order, dict keys sorted).  bfloat16 leaves are stored as
their raw 16 bits with dtype ``"bfloat16"`` in the manifest, as the
reference stores them.  A save is atomic (a ``.tmp`` directory renamed
once complete) and may run on a thread of its own; ``restore`` picks
the newest committed step and places each leaf on its template leaf's
device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from .convert import keystr, tree_paths


def _unflatten(template, by_path, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], by_path, prefix + (k,))
                for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(v, by_path, prefix + (i,))
                              for i, v in enumerate(template))
    return by_path(keystr(prefix), template)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as a host numpy array of its own (bf16 as raw uint16 bits,
    with the dtype name kept by the caller)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    return np.array(leaf)


def _dtype_name(leaf) -> str:
    if torch.is_tensor(leaf):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_leaf(arr: np.ndarray, dtype: str, template):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if torch.is_tensor(template):
        return t.to(template.device)
    return t


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, blocking: bool = True):
        """Snapshot ``tree`` to host memory now; write it to disk now or,
        with ``blocking=False``, on a thread (``wait()`` joins it)."""
        host = [(path, _to_numpy(leaf), _dtype_name(leaf))
                for path, leaf in tree_paths(tree)]
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host):
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        arrays = {}
        for i, (name, arr, dt) in enumerate(host):
            key = f"a{i}"
            manifest["leaves"].append(
                {"path": name, "key": key, "shape": list(arr.shape),
                 "dtype": dt})
            arrays[key] = arr
        np.savez(os.path.join(tmp, "shard_0_0.npz"), **arrays)
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMIT"), "w") as f:
            f.write(str(time.time()))
        if not os.path.exists(path):
            os.replace(tmp, path)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._gc()

    def _gc(self):
        for s in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def committed_steps(self):
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "COMMIT")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        """``(tree, step)``: the checkpoint of ``step`` (None: the newest
        committed one) in ``template``'s structure, each leaf a tensor on
        its template leaf's device in the saved dtype.  Raises
        ``KeyError`` on a path the checkpoint lacks and ``ValueError`` on
        a shape that differs from the template's."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        leaves = {leaf["path"]: leaf for leaf in manifest["leaves"]}
        with np.load(os.path.join(path, "shard_0_0.npz")) as data:
            def load(name, tmpl):
                meta = leaves[name]
                arr = data[meta["key"]]
                shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else ()
                if tuple(arr.shape) != shape:
                    raise ValueError(f"checkpoint leaf {name}: shape "
                                     f"{tuple(arr.shape)}, expected {shape}")
                return _to_leaf(arr, meta["dtype"], tmpl)
            tree = _unflatten(template, load)
        return tree, step
