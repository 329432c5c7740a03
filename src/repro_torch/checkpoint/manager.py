"""Fault-tolerant checkpointing: atomic, manifest-verified, on the host.

Layout of one checkpoint (the reference package's format, so either
package reads the other's checkpoints)::

    <dir>/step_000123/
        manifest.json        # step, per-leaf path/shape/dtype/crc, extra
        leaf_00000.npy ...   # one .npy per tree leaf (on the host)

Write protocol (atomicity against preemption mid-write):
  1. serialize into ``step_N.tmp-<pid>``, fsyncing every leaf file,
  2. write the manifest LAST (a checkpoint without a manifest is invalid
     by construction),
  3. atomic ``os.rename`` to ``step_N``, then GC of old steps and of
     stale temporary directories.

``latest()``/``restore()`` skip temp dirs and any directory whose
manifest is missing or whose CRCs mismatch, so a job killed mid-save
restarts from the previous complete checkpoint.  ``keep`` bounds disk
use.

Trees are nested dicts, lists, tuples and dataclasses; anything else is a
leaf (torch tensors go to the host with ``.detach().cpu().numpy()``).  Leaf
paths are the strings ``jax.tree_util.keystr`` gives for the same tree
(``['name']`` for a dict key, ``[i]`` for a sequence index, ``.name`` for
a field of a registered dataclass such as a ``TrainState``), in the same
order (dict keys sorted, fields in declaration order), and every leaf is
recorded as replicated (a single-host gather layout).

bfloat16 leaves (numpy has no such dtype) are written as their 16-bit
patterns, a ``uint16`` array, with ``"dtype": "bfloat16"`` in the manifest
and the CRC over those bytes, and restored bitwise; every other leaf keeps
the format above.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"

# The path of a single-level {"name": leaf} dict: ['name'].  Flat-dict
# checkpoints (the serving-state layout repro_torch.serve.recovery
# writes) are restored by NAME via restore_items, so the reader does not
# need a ``like`` tree whose structure it cannot know before reading.
_FLAT_KEY = re.compile(r"\['([^']*)'\]")


def _flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's leaf order: dict keys
    sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten_with_paths(getattr(tree, f.name), f"{prefix}.{f.name}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_paths(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves`` (the flattened order: dict keys sorted).  Each dict
    keeps ``like``'s key order, so a restored tree iterates as the tree that
    was saved: a sum over its leaves in dict order (the optimizer's global
    norm) rounds as it did before the restore."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{f.name: _unflatten(getattr(like, f.name), leaves)
                                            for f in dataclasses.fields(like)})
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> tuple[np.ndarray, str]:
    """``(array, manifest dtype)``: a bfloat16 tensor as its uint16 bit
    patterns, dtype ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc32(arr: np.ndarray) -> int:
    """``zlib.crc32(arr.tobytes())`` without the copy of a C-contiguous
    array."""
    return zlib.crc32(np.ascontiguousarray(arr))


def _cast_like(arr: np.ndarray, leaf, dtype: str):
    """``arr`` (of manifest dtype ``dtype``) in the dtype of the ``like``
    leaf: a tensor of its dtype on its device for a torch tensor, else a
    numpy array.  A bfloat16 leaf's bit patterns become a bfloat16 tensor
    bit for bit."""
    if dtype == _BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype)
        arr = t.float().numpy()
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    tgt = np.asarray(leaf).dtype if hasattr(leaf, "dtype") else arr.dtype
    return arr.astype(tgt, copy=False)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, extra: dict | None = None) -> str:
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = f"{final}.tmp-{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)

        entries = []
        for i, (path, leaf) in enumerate(_flatten_with_paths(state)):
            arr, dtype = _host(leaf)
            fname = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            entries.append(
                {
                    "path": path,
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "crc32": _crc32(arr),
                    "sharding": "replicated",  # single-host gather layout
                }
            )
        manifest = {"step": step, "leaves": entries, "extra": extra or {}}
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):  # re-save of the same step
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    # -- read -------------------------------------------------------------
    def available_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or ".tmp-" in name:
                continue
            if not os.path.exists(os.path.join(self.directory, name, _MANIFEST)):
                continue  # incomplete (killed mid-write)
            steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest(self) -> int | None:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def _read(self, step: int | None):
        """``(manifest, leaf loader)`` of ``step`` (the newest by
        default); the loader CRC-verifies every leaf."""
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        cdir = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(cdir, _MANIFEST)) as f:
            manifest = json.load(f)

        def load(e: dict) -> np.ndarray:
            arr = np.load(os.path.join(cdir, e["file"]))
            if _crc32(arr) != e["crc32"]:
                raise IOError(f"crc mismatch for {e['path']} in {cdir}")
            return arr

        return manifest, load

    def restore(self, like: Any, step: int | None = None) -> tuple[Any, dict]:
        """Restore into the structure of ``like``; returns (state, extra).

        Verifies every leaf CRC; a corrupt checkpoint raises and the
        caller falls back to an earlier step (see ``restore_latest``).
        Each leaf takes the dtype of its ``like`` leaf (a torch tensor
        also its device)."""
        manifest, load = self._read(step)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = [_cast_like(load(by_path[path]), leaf, by_path[path]["dtype"])
               for path, leaf in _flatten_with_paths(like)]
        return _unflatten(like, iter(out)), manifest["extra"]

    def restore_items(
        self, step: int | None = None
    ) -> tuple[dict[str, np.ndarray], dict]:
        """CRC-verified restore of a flat single-level dict checkpoint
        WITHOUT a ``like`` tree: returns ``({name: array}, extra)``.

        This is the reader for serving-state checkpoints
        (:mod:`repro_torch.serve.recovery`), whose structure (how many
        flights, which prep leaves) is itself part of the checkpoint.
        Leaf names come from the manifest paths (``['name']`` for a flat
        dict); non-flat paths are returned under their full path.  A
        bfloat16 leaf comes back as its uint16 bit patterns."""
        manifest, load = self._read(step)
        items: dict[str, np.ndarray] = {}
        for e in manifest["leaves"]:
            m = _FLAT_KEY.fullmatch(e["path"])
            items[m.group(1) if m else e["path"]] = load(e)
        return items, manifest["extra"]

    def restore_latest_items(
        self,
    ) -> tuple[dict[str, np.ndarray], dict, int] | None:
        """Walk checkpoints newest-first until one verifies (same
        fallback contract as :meth:`restore_latest`, flat-dict reader)."""
        for step in reversed(self.available_steps()):
            try:
                items, extra = self.restore_items(step)
                return items, extra, step
            except (IOError, KeyError, ValueError, json.JSONDecodeError):
                continue
        return None

    def restore_latest(self, like: Any) -> tuple[Any, dict, int] | None:
        """Walk checkpoints newest-first until one verifies; None if none."""
        for step in reversed(self.available_steps()):
            try:
                state, extra = self.restore(like, step)
                return state, extra, step
            except (IOError, KeyError, json.JSONDecodeError):
                continue
        return None

    # -- gc ---------------------------------------------------------------
    def _gc(self):
        steps = self.available_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"))
        # stale temp dirs from crashed writers
        for name in os.listdir(self.directory):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
