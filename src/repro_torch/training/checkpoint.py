"""Fault-tolerant checkpoints: atomic, keep-k, restored onto any device.

Port of ``repro/training/checkpoint.py``, in its layout:
``<dir>/step_<n>/state.npz`` plus a ``<dir>/step_<n>/DONE`` marker. A save
writes into a temporary directory and renames it, so a crash mid-save never
corrupts the newest checkpoint; ``list_checkpoints`` counts only
directories with ``DONE``.

* Keys: each leaf's tree path (dict keys, sequence indices) joined by
  ``SEP``, as the reference's ``_flatten`` writes them, so a float32
  checkpoint of either package restores in the other.
* bfloat16 leaves are stored as the reference stores them: numpy has no
  bfloat16, and ``np.savez`` writes JAX's as 2-byte void records (``V2``)
  of the bf16 bits. The port writes the same records without
  ``ml_dtypes`` and reads every ``V2`` leaf back as bf16 bits. (The
  reference's restore casts ``V2`` with ``astype`` and raises, so it
  cannot resume from its own bf16 checkpoints; the port can.)
* Host integers (the port's ``step`` and ``opt["count"]``) are stored as
  int32 arrays, as the reference's are, and come back as ints.
* Restore is elastic: each leaf lands on the template leaf's device, or
  on ``device``; a checkpoint written on the card restores on the CPU
  and the reverse. On the template's own device it is copied into the
  template's tensors, so resuming takes no second copy of the state on
  the device.
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

SEP = "//"
_BF16_RECORD = np.dtype("V2")       # how np.savez stores a bfloat16 leaf


def _items(tree, prefix=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted (JAX
    flattens dicts by sorted key), sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _to_host(leaf) -> np.ndarray:
    """A leaf as the array the reference's checkpoint holds for it: a copy
    in host memory (a CPU tensor is copied too, since training updates it
    in place)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RECORD)
        return t.numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """{key: host array}: a copy of every leaf, taken now (bf16 as ``V2``
    records, ints as int32)."""
    return {SEP.join(path): _to_host(leaf) for path, leaf in _items(tree)}


def save_checkpoint(ckpt_dir: str, step: int, state, *, keep: int = 3) -> str:
    """Write ``state`` (a tree of tensors, ints or host arrays) as step
    ``step``: into a temporary directory, renamed into place, then all
    but the newest ``keep`` checkpoints removed. Returns the directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "state.npz"), **_flatten(state))
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write(str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic on one file system
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def list_checkpoints(ckpt_dir: str) -> List[int]:
    """The steps of the complete checkpoints (those with ``DONE``), sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "DONE")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _from_host(arr: np.ndarray, tmpl, device):
    """The stored array as a leaf like ``tmpl``: without ``device``,
    ``tmpl`` itself with the stored values copied in (in its dtype); with
    ``device``, a new tensor there in ``tmpl``'s dtype keeping its
    ``requires_grad``; an int for an int template."""
    if not isinstance(tmpl, torch.Tensor):
        return type(tmpl)(arr.item())
    if arr.dtype == _BF16_RECORD:
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    if device is None:
        with torch.no_grad():
            return tmpl.copy_(t)
    return t.to(device=device, dtype=tmpl.dtype).requires_grad_(tmpl.requires_grad)


def restore_checkpoint(ckpt_dir: str, template, *, step: Optional[int] = None, device=None):
    """Restore into the structure of ``template`` (a tree of tensors and
    ints: the state to resume, or one of the same shapes). The newest
    checkpoint unless ``step``. Without ``device`` the stored values are
    copied into the template's own tensors (which keep their dtype, device
    and ``requires_grad``), so no second copy of the state is made there;
    with ``device`` (a template on another device, or on ``meta``) each
    leaf is a new tensor on ``device`` in the template leaf's dtype, with
    its ``requires_grad`` (a restore that raises may leave the template's
    earlier leaves overwritten). Raises
    ``FileNotFoundError`` without a checkpoint, ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for one of another shape. Returns
    (state, step)."""
    if step is None:
        step = latest_checkpoint(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "state.npz")
    with np.load(path) as data:
        def leaf(path, tmpl):
            key = SEP.join(path)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: ckpt shape {arr.shape} != template {shape}")
            return _from_host(arr, tmpl, device)

        def build(tree, path=()):
            if isinstance(tree, dict):
                return {k: build(v, path + (str(k),)) for k, v in tree.items()}
            if isinstance(tree, (tuple, list)):
                return type(tree)(build(v, path + (str(i),)) for i, v in enumerate(tree))
            return leaf(path, tree)

        return build(template), step


class AsyncCheckpointer:
    """Saves on a background thread. ``save`` copies the state to host
    memory on the caller's thread before it returns (the port's AdamW
    updates the parameters in place, so a thread reading device tensors
    would save a later step's values), then writes and renames off-thread.
    One save in flight at a time: a new save first waits for the previous
    one. ``wait()`` joins it and raises its error, if any."""

    THREAD_NAME = "checkpoint-writer"

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state) -> None:
        self.wait()
        host_state = _flatten(state)

        def _run():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state, keep=self.keep)
            except BaseException as e:            # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, name=self.THREAD_NAME, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
