"""Checkpoints with atomic commit (port of ``repro.ckpt.checkpoint``).

Layout on disk, the JAX package's byte for byte: ``<dir>/step_%08d/`` holds
one ``.npy`` per leaf (file name = the '/'-joined key with '/' -> '__') and
``manifest.json`` with ``step``, the sorted ``keys`` and ``extra``. Keys
follow ``jax.tree_util``'s paths: a dict entry is its key, a list entry its
index, a dataclass field ``.<name>``. A step directory is written under a
temp name and atomically renamed, so a crashed writer never leaves a half
checkpoint that restore would accept.

Leaves are tensors (saved from the host; restored onto the template leaf's
device with its dtype) and Python ints and floats. Dataclasses flatten by
field and dicts by key, without ``jax.tree_util``; ``None``, bools and
strings are structure, taken from the template on restore.

Atomicity:

* the temp dir name carries the writer's pid (``.tmp_<pid>_...``); temp
  dirs of *dead* writers are swept on the next ``save``. ``latest_step`` /
  ``restore`` never look at dotted names, so a leaked temp dir is invisible
  to readers.
* overwriting an existing ``step_<N>`` never deletes it before the new data
  is committed: the old dir is moved aside to ``.old_<pid>_<N>``, the temp
  dir is renamed in, and only then is the old copy removed. A kill in the
  move-aside window is repaired by the sweep: a dead writer's ``.old`` dir
  is renamed back when ``step_<N>`` is missing, discarded when the commit
  did land.
* ``os.replace`` is the only publication point.

Nothing here catches an exception. The injected ``ckpt.save`` crash
(``repro_torch.testing.chaos``) is asked for before the commit: ``_save``
then removes its temp dir, leaves the old step as it was and returns the
fault, which ``save`` raises. A real ``OSError`` propagates and may leave
one ``.tmp_<pid>_`` directory behind, which readers never see and which
the first ``save`` after the writer has exited sweeps. A manifest that is
not one whole JSON object (a truncated file) marks its step corrupt; one
that is whole but does not parse raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..testing import chaos

Tree = Any


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory exists but is not loadable (truncated
    manifest, missing leaf file)."""


def _whole_json_object(s: str) -> bool:
    """True when ``s`` is one JSON object, whitespace aside, whose strings
    close and whose brackets balance: what a truncated write is not."""
    body = s.strip()
    if not body.startswith("{"):
        return False
    depth, in_str, esc = 0, False, False
    for i, c in enumerate(body):
        if in_str:
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c in "{[":
            depth += 1
        elif c in "}]":
            depth -= 1
            if depth == 0:
                return i == len(body) - 1
    return False


def _read_manifest(d: pathlib.Path) -> Tuple[Optional[dict], Optional[str]]:
    """-> (manifest, None) or (None, why ``d`` is not restorable)."""
    mpath = d / "manifest.json"
    if not mpath.exists():
        return None, "missing manifest.json"
    text = mpath.read_bytes().decode("utf-8", errors="replace")
    if not _whole_json_object(text):
        return None, "unreadable manifest.json (not one whole JSON object)"
    manifest = json.loads(text)
    keys = manifest.get("keys")
    if not isinstance(keys, list):
        return None, "manifest.json has no 'keys' list"
    for key in keys:
        if not (d / (str(key).replace("/", "__") + ".npy")).exists():
            return None, f"missing leaf file for key {key!r}"
    return manifest, None


def is_intact(step_dir: str | pathlib.Path) -> bool:
    """True if ``step_dir`` is a restorable checkpoint."""
    return _read_manifest(pathlib.Path(step_dir))[1] is None


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or (
        isinstance(x, (int, float)) and not isinstance(x, bool))


def _children(tree):
    """(key, child) pairs of a container, in ``jax.tree_util``'s order."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    if _is_leaf(tree):
        return {prefix: tree}
    flat = {}
    for key, child in _children(tree):
        flat.update(_flatten(child, f"{prefix}/{key}" if prefix else key))
    return flat


def _rebuild(tree: Tree, loaded: Dict[str, Any], prefix: str = "") -> Tree:
    if _is_leaf(tree):
        return loaded[prefix]
    kids = {key: _rebuild(child, loaded, f"{prefix}/{key}" if prefix
                          else key) for key, child in _children(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{k[1:]: v for k, v in kids.items()})
    if isinstance(tree, dict):
        return {k: kids[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(kids[str(i)] for i in range(len(tree)))
    return tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _pid_alive(pid: int) -> bool:
    """Whether process ``pid`` exists (a zombie counts), read from
    ``/proc``."""
    return os.path.exists(f"/proc/{int(pid)}")


def _writer_pid(name: str) -> Optional[int]:
    """pid embedded in a ``.tmp_<pid>_...`` / ``.old_<pid>_<step>`` name,
    or None for foreign dotted names."""
    parts = name.split("_")
    if len(parts) >= 3 and parts[0] in (".tmp", ".old") and \
            parts[1].isdigit():
        return int(parts[1])
    return None


def sweep_stale(ckpt_dir: str | pathlib.Path) -> int:
    """Clean up after killed writers: delete ``.tmp`` dirs whose writer pid
    is dead, and repair ``.old`` dirs, renamed back to their ``step_<N>``
    when the kill happened in the move-aside window, deleted when the
    commit did land. Returns the number of entries handled. Called by
    every ``save``; idempotent."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return 0
    handled = 0
    for d in ckpt_dir.iterdir():
        pid = _writer_pid(d.name)
        if pid is None or _pid_alive(pid):
            continue
        if d.name.startswith(".tmp_"):
            shutil.rmtree(d, ignore_errors=True)
            handled += 1
        elif d.name.startswith(".old_"):
            final = ckpt_dir / ("step_" + d.name.split("_", 2)[2])
            if final.exists():
                shutil.rmtree(d, ignore_errors=True)
            else:
                os.replace(d, final)    # the new save never committed
            handled += 1
    return handled


def _save(ckpt_dir: pathlib.Path, step: int, tree: Tree,
          extra: Optional[Dict]) -> Tuple[pathlib.Path,
                                          Optional[RuntimeError]]:
    """Write and commit ``step_<N>``. -> (final path, None), or (final
    path, the injected ``ckpt.save`` fault) with the temp dir removed and
    any earlier ``step_<N>`` left as it was."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    sweep_stale(ckpt_dir)
    pid = os.getpid()
    final = ckpt_dir / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir,
                                        prefix=f".tmp_{pid}_"))
    flat = _flatten(tree)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {}}
    for key, leaf in flat.items():
        np.save(tmp / (key.replace("/", "__") + ".npy"), _host(leaf))
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    fault = chaos.injected_fault("ckpt.save")   # emulated crash
    if fault is not None:
        shutil.rmtree(tmp, ignore_errors=True)
        return final, fault
    old = ckpt_dir / f".old_{pid}_{step:08d}"
    moved_aside = final.exists()
    if moved_aside:
        # a stale .old from an earlier partial cleanup (or pid reuse) would
        # make os.replace fail with ENOTEMPTY
        shutil.rmtree(old, ignore_errors=True)
        os.replace(final, old)           # move aside, never delete first
    os.replace(tmp, final)               # atomic commit
    if moved_aside:
        shutil.rmtree(old, ignore_errors=True)
    return final, None


def save(ckpt_dir: str | pathlib.Path, step: int, tree: Tree,
         extra: Optional[Dict] = None) -> pathlib.Path:
    """Write ``step_<N>`` with an atomic rename commit. Returns the final
    path; raises the injected ``ckpt.save`` fault."""
    final, fault = _save(pathlib.Path(ckpt_dir), step, tree, extra)
    if fault is not None:
        raise fault
    return final


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    """Newest *intact* committed step, or None. A corrupt newest checkpoint
    is skipped, so a restart falls back to the last restorable one."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and is_intact(d)]
    return max(steps) if steps else None


def read_extra(ckpt_dir: str | pathlib.Path, step: int) -> Dict:
    """The ``extra`` dict of a committed step's manifest, without loading
    any leaves."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest, why = _read_manifest(d)
    if why is not None:
        raise CheckpointCorrupt(f"checkpoint {d} is corrupt: {why}")
    return manifest.get("extra", {})


def restore(ckpt_dir: str | pathlib.Path, tree_like: Tree,
            step: Optional[int] = None) -> Tuple[Tree, Dict]:
    """Load into the structure of ``tree_like``: each tensor leaf onto the
    template leaf's device with its dtype, each number as the template's
    type. -> (tree, extra)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    if not d.exists():
        raise FileNotFoundError(f"no checkpoint {d}")
    manifest, why = _read_manifest(d)
    if why is not None:
        raise CheckpointCorrupt(f"checkpoint {d} is corrupt: {why}")
    loaded = {}
    for key, like in _flatten(tree_like).items():
        arr = np.load(d / (key.replace("/", "__") + ".npy"))
        if isinstance(like, torch.Tensor):
            loaded[key] = torch.from_numpy(arr).to(device=like.device,
                                                   dtype=like.dtype)
        else:
            loaded[key] = type(like)(arr.item())
    return _rebuild(tree_like, loaded), manifest["extra"]
