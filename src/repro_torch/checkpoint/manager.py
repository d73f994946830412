"""Checkpointing with atomic writes, keep-k retention, async save and
resume (fault-tolerance substrate).

Port of the JAX package's ``checkpoint/manager.py``, with its layout:

    <dir>/step_<N>/
        arrays.npz      the tree's leaves, ``leaf_<i>`` in the reference's
                        leaf order (dict keys sorted), gathered to the host;
                        bfloat16 as a ``uint16`` view
        meta.json       step, tree structure, dtypes, optional timestamp
    <dir>/LATEST        pointer file, written by rename

so a directory the reference wrote restores into the port, leaf for leaf
(the ``treedef`` string is each package's own and is not read back).
Manifests are byte-reproducible: ``save`` records the ``timestamp`` its
caller passes (``None`` by default) and reads no clock.  The leaves are
copied to the host inside ``save``, before it returns, so a caller may go
on to change its tensors while the files are written in the background.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from .._tree import flatten, leaves, structure, unflatten


def _to_numpy(x) -> Tuple[np.ndarray, str]:
    """npz-safe encoding; bfloat16 round-trips bitwise via a uint16 view.
    A tensor is copied to the host even when it lies there already: the
    asynchronous writer must not share memory that the optimizer then
    updates in place (AdamW's moments), or it writes a later step."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _from_numpy(a: np.ndarray, dtype_name: str,
                device: torch.device) -> torch.Tensor:
    # np.load hands out a fresh array for each leaf: no copy is needed
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: Union[str, Path], keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------
    def save(self, step: int, tree: Any, *, block: bool = False,
             timestamp: Optional[float] = None) -> Path:
        """Write ``step_<step>/``.  ``timestamp`` is recorded verbatim in
        the manifest (``None`` by default — a wall-clock read here would
        make byte-identical training runs emit differing checkpoints)."""
        flat, treedef = flatten(tree)
        arrays, dtypes = {}, {}
        for i, x in enumerate(flat):               # gathered to the host
            arrays[f"leaf_{i}"], dtypes[f"leaf_{i}"] = _to_numpy(x)
        meta = {"step": int(step), "treedef": str(treedef),
                "n_leaves": len(arrays), "dtypes": dtypes,
                "time": timestamp}

        def _write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(meta))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            latest_tmp = self.dir / ".LATEST.tmp"
            latest_tmp.write_text(f"step_{step}")
            os.rename(latest_tmp, self.dir / "LATEST")
            self._gc()

        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
        return self.dir / f"step_{step}"

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------
    def steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if (p / "meta.json").exists()]

    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if ptr.exists():
            name = ptr.read_text().strip()
            path = self.dir / name
            if (path / "meta.json").exists():
                return int(name.split("_")[1])
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``like``: tensors of the stored
        types, each on ``device`` when given, else on the device of
        ``like``'s leaf in its place (the host for a leaf that is not a
        tensor).  Raises ``ValueError`` when the leaf counts differ."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        data = np.load(self.dir / f"step_{step}" / "arrays.npz")
        meta = json.loads((self.dir / f"step_{step}" / "meta.json")
                          .read_text())
        dtypes = meta.get("dtypes", {})
        like_leaves = leaves(like)
        if len(like_leaves) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, expected "
                f"{len(like_leaves)} — config/topology mismatch")
        new_leaves = []
        for i, ref in enumerate(like_leaves):
            dev = torch.device(device) if device is not None else (
                ref.device if isinstance(ref, torch.Tensor)
                else torch.device("cpu"))
            new_leaves.append(_from_numpy(data[f"leaf_{i}"],
                                          dtypes.get(f"leaf_{i}", ""), dev))
        return unflatten(structure(like), new_leaves), step
