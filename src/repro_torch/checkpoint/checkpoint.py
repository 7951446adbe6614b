"""Fault-tolerant checkpointing: npz + manifest, atomic rename, async
writer, retention.  The port of ``repro.checkpoint.checkpoint``, in its
on-disk layout:

    <dir>/step_<N>/
        manifest.json  — leaf paths, shapes, dtypes
        arrays.npz     — one entry a leaf: its raw bytes (uint8)
    <dir>/step_<N>.tmp/ — an in-flight write (the rename commits it)

A tree is nested dicts, NamedTuples, lists and tuples whose leaves are
tensors, numpy arrays or Python scalars; a leaf's path joins the keys
and field names with "/".  Every leaf is stored as its raw bytes with its
dtype named in the manifest, so bf16 needs no ``ml_dtypes``.  The
newest *complete* step (manifest present, every array readable) is the
restart point; torn or corrupt steps are skipped.

A checkpoint always holds the full leaves.  A run on a mesh writes the
gathered leaves from one rank (``train.trainer``), and
``restore_checkpoint(shardings=, mesh=)`` cuts each leaf to this rank's
block of any mesh: a checkpoint written on one mesh restores onto
another or onto one device.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16,
    torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
    torch.bool)}


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree: Any, prefix: str = "",
                        is_leaf=None) -> List[Tuple[str, Any]]:
    kids = None if is_leaf is not None and is_leaf(tree) else _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k,
                                   is_leaf)
    return out


def _is_spec(node) -> bool:
    """A layout (a tuple of axis names, tuples of them and Nones), not a
    tuple of subtrees."""
    return isinstance(node, tuple) and not hasattr(node, "_fields") and all(
        a is None or isinstance(a, str) or (
            isinstance(a, tuple) and all(isinstance(x, str) for x in a))
        for a in node)


def _to_cpu_tensor(leaf) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor of its own (a copy)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, bool):
        return torch.tensor(leaf)
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int32)
    return torch.from_numpy(np.array(leaf))


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write one checkpoint atomically.  Returns the committed path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "format": 1, "leaves": [], "meta": {}}
    for path, leaf in _flatten_with_paths(tree):
        t = _to_cpu_tensor(leaf)
        arrays[path] = t.reshape(-1).view(torch.uint8).numpy() \
            if t.numel() else np.zeros(0, np.uint8)
        manifest["leaves"].append({
            "path": path, "shape": list(t.shape),
            "dtype": str(t.dtype).removeprefix("torch.")})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    # manifest LAST: its presence marks the step as complete
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _is_complete(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            names = set(z.files)
        return all(leaf["path"] in names for leaf in manifest["leaves"])
    except (OSError, ValueError, KeyError):
        return False


def _steps(directory: str) -> List[int]:
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest complete checkpoint step, skipping corrupt or partial ones."""
    if not os.path.isdir(directory):
        return None
    for s in reversed(_steps(directory)):
        if _is_complete(os.path.join(directory, f"step_{s:08d}")):
            return s
    return None


def _from_bytes(raw: np.ndarray, meta: Dict[str, Any]) -> torch.Tensor:
    t = torch.from_numpy(raw.copy())
    return t.view(_DTYPES[meta["dtype"]]).reshape(meta["shape"])


def restore_checkpoint(directory: str, step: int, like: Any,
                       shardings: Optional[Any] = None, mesh=None) -> Any:
    """The checkpoint in the structure of ``like``: a tensor leaf comes back
    on ``like``'s device in its dtype, a Python scalar as that type.
    ``shardings``: a tree of layouts like ``like``'s (tuples of axis
    names, ``launch.sharding``) whose tensor leaves come back as this
    rank's block on ``mesh`` of the stored full leaf (the reference's
    elastic resume onto another mesh or device count)."""
    specs = None
    if shardings is not None:
        if mesh is None:
            raise ValueError("restoring to shardings needs their mesh")
        from repro_torch.launch.sharding import local_shard
        specs = dict(_flatten_with_paths(shardings, is_leaf=_is_spec))
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = {leaf["path"]: leaf for leaf in json.load(f)["leaves"]}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        data = {k: z[k] for k in z.files}

    def rebuild(node, prefix):
        kids = _children(node)
        if kids is None:
            if prefix not in data:
                raise KeyError(f"checkpoint missing leaf {prefix}")
            t = _from_bytes(data[prefix], meta[prefix])
            if isinstance(node, torch.Tensor):
                if specs is not None and specs.get(prefix):
                    t = local_shard(t, specs[prefix], mesh)
                return t.to(device=node.device, dtype=node.dtype)
            if isinstance(node, (bool, int, float)):
                return type(node)(t.item())
            return t.numpy().astype(np.asarray(node).dtype)
        vals = [rebuild(v, f"{prefix}/{k}" if prefix else k)
                for k, v in kids]
        if isinstance(node, dict):
            return dict(zip(node.keys(), vals))
        if hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    return rebuild(like, "")


class CheckpointManager:
    """Async checkpointing with a bounded queue and a retention policy:
    ``save`` copies the tree to the host, a writer thread commits it and
    keeps the newest ``keep`` steps."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: List[str] = []
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, tree = item
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except Exception as e:                 # noqa: BLE001 (reported)
                self._errors.append(f"step {step}: {e!r}")
            finally:
                self._q.task_done()

    def _gc(self):
        steps = _steps(self.directory)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def save(self, step: int, tree: Any) -> None:
        # a host copy before queuing, so the caller may go on updating the
        # state in place
        self._q.put((step, {p: _to_cpu_tensor(leaf)
                            for p, leaf in _flatten_with_paths(tree)}))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise RuntimeError("; ".join(self._errors))

    def close(self) -> None:
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join(timeout=30)
            self._thread = None
