"""Atomic, async checkpointing: the port of ``repro.ckpt.checkpoint``.

The layout is the reference's, so a checkpoint written by either package
restores in the other:

    <dir>/step_<n:08d>/arrays.npz + manifest.json   (atomic via tmp + rename)

with one array per leaf under the key ``"a/b/c"`` of its path (dict keys,
tuple indices), as ``repro.ckpt.checkpoint._flatten`` writes it.  ``save``
and ``AsyncSaver.save`` copy the tree to host memory at once (so training
may go on changing its tensors) and write numpy arrays; ``restore`` reads
them back into a template's structure, each leaf on the template leaf's
device with the dtype it was saved in.  numpy has no bfloat16: a bf16 leaf
is saved as f32 (exactly) and restored as bf16 where the template's leaf
is bf16.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _host(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy()


def _flatten(t: Any) -> dict[str, np.ndarray]:
    return {tree.key(path): _host(leaf) if isinstance(leaf, torch.Tensor)
            else np.asarray(leaf) for path, leaf in tree.leaves_with_path(t)}


def save(ckpt_dir: str, step: int, t: Any, extra: dict | None = None) -> str:
    """Synchronous atomic save.  Returns the final step directory."""
    return _write(ckpt_dir, step, _flatten(t), extra)


def _write(ckpt_dir: str, step: int, flat: dict[str, np.ndarray],
           extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "n_arrays": len(flat),
            "bytes": int(sum(a.nbytes for a in flat.values())),
            **(extra or {}),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


class AsyncSaver:
    """Snapshot-now, write-later checkpointing (one in flight at a time)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, ckpt_dir: str, step: int, t: Any,
             extra: dict | None = None) -> None:
        self.wait()
        flat = _flatten(t)                        # synchronous snapshot

        def _run():
            try:
                _write(ckpt_dir, step, flat, extra)
            except BaseException as e:            # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and os.path.isfile(
            os.path.join(ckpt_dir, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any,
            step: int | None = None) -> tuple[Any, int]:
    """Load a checkpoint into ``template``'s structure: ``(tree, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}

    def load(p, leaf):
        k = tree.key(p)
        if k not in flat:
            raise KeyError(f"checkpoint missing leaf {k!r}")
        arr = flat[k]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {k}: ckpt {arr.shape} vs "
                f"{tuple(leaf.shape)}")
        out = torch.from_numpy(arr).to(leaf.device)
        return out.to(torch.bfloat16) if leaf.dtype == torch.bfloat16 else out

    return tree.map_with_path(load, template), step
