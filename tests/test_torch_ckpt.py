"""The port's checkpoints (``repro_torch.ckpt.checkpoint``).

JAX's ``ckpt`` tests (``tests/test_traj.py``) on the port's module: a crash
before the commit keeps the old step, the sweep repairs dead writers, a
re-save over a stale ``.old`` dir, a writer killed mid-save. The layout on
disk is JAX's: ``latest_step``, ``is_intact``, ``read_extra`` and
``sweep_stale`` of both packages agree on the same directories, and each
package restores what the other wrote. What differs: ``_pid_alive`` reads
``/proc`` where JAX calls ``kill(pid, 0)``, and nothing is caught.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.ckpt import checkpoint as jckpt
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.testing import chaos

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEAD = 2 ** 22 + 12345             # no such pid


def test_ckpt_crash_before_commit_preserves_old(tmp_path):
    """A crash inside save (before the atomic rename) leaves the previous
    checkpoint of the same step intact and restorable."""
    d = tmp_path / "ck"
    tree = {"x": torch.arange(8.0)}
    ckpt.save(d, 5, tree, extra={"gen": 1})
    with chaos.inject(chaos.FaultSpec("ckpt.save", "error", p=1.0), seed=0):
        with pytest.raises(chaos.TransientBackendError):
            ckpt.save(d, 5, {"x": torch.arange(8.0) * 2}, extra={"gen": 2})
    assert ckpt.latest_step(d) == 5
    restored, extra = ckpt.restore(d, tree)
    assert torch.equal(restored["x"], torch.arange(8.0))
    assert extra == {"gen": 1}
    assert not [f for f in os.listdir(d) if f.startswith(".tmp_")]


def test_ckpt_sweep_repairs_dead_writers(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(d, 3, {"x": torch.zeros(4)})
    os.replace(d / "step_00000003", d / f".old_{DEAD}_00000003")
    (d / f".tmp_{DEAD}_junk").mkdir()
    assert ckpt.latest_step(d) is None
    assert ckpt.sweep_stale(d) == 2
    assert ckpt.latest_step(d) == 3
    assert not (d / f".tmp_{DEAD}_junk").exists()
    mine = d / f".tmp_{os.getpid()}_busy"
    mine.mkdir()
    assert ckpt.sweep_stale(d) == 0
    assert mine.exists()


def test_ckpt_resave_over_stale_old_dir(tmp_path):
    d = tmp_path / "ck"
    ckpt.save(d, 7, {"x": torch.zeros(4)})
    stale = d / f".old_{os.getpid()}_00000007"   # own pid: sweep skips it
    stale.mkdir()
    (stale / "junk.npy").write_bytes(b"x")
    ckpt.save(d, 7, {"x": torch.ones(4)})
    restored, _ = ckpt.restore(d, {"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.ones(4))
    assert not stale.exists()


def test_pid_alive_reads_proc():
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    child.wait()                       # reaped: its /proc entry is gone
    assert ckpt._pid_alive(os.getpid()) is True
    assert ckpt._pid_alive(child.pid) is False
    assert ckpt._pid_alive(DEAD) is False
    assert ckpt._writer_pid(f".tmp_{DEAD}_x") == DEAD
    assert ckpt._writer_pid(".tmp_abc_x") is None
    assert ckpt._writer_pid("step_00000001") is None


def test_ckpt_kill_mid_save_subprocess(tmp_path):
    """SIGKILL mid-save: whatever instant the writer dies at, latest_step
    and restore only ever see intact checkpoints."""
    d = tmp_path / "ck"
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, %r)\n"
        "from repro_torch.ckpt import checkpoint as ckpt\n"
        "tree = {'x': torch.arange(200000.0)}\n"
        "ckpt.save(%r, 1, tree)\n"
        "print('committed', flush=True)\n"
        "for i in range(2, 50):\n"
        "    ckpt.save(%r, i, tree)\n"
    ) % (str(ROOT / "src"), str(d), str(d))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE)
    proc.stdout.readline()
    proc.kill()
    proc.wait()
    last = ckpt.latest_step(d)
    assert last is not None and last >= 1
    restored, _ = ckpt.restore(d, {"x": torch.arange(200000.0)})
    assert torch.equal(restored["x"], torch.arange(200000.0))
    ckpt.sweep_stale(d)
    assert not [f for f in os.listdir(d) if f.startswith(".tmp_")]


def _scenes(root: pathlib.Path):
    """Checkpoint directories in every state the readers tell apart,
    written by JAX's writer."""
    d = root / "ck"
    for step in (1, 2, 3, 4, 5, 6):
        jckpt.save(d, step, {"x": jnp.arange(4.0), "y": {"z": jnp.ones(2)}},
                   extra={"steps_done": step, "ncells": [4, 4, 4]})
    (d / "step_00000002" / "manifest.json").unlink()
    (d / "step_00000003" / "x.npy").unlink()
    m = d / "step_00000004" / "manifest.json"
    m.write_text(m.read_text()[:25])                   # truncated
    (d / "step_00000005" / "manifest.json").write_text(
        json.dumps({"step": 5, "extra": {}}))          # no keys list
    (d / f".tmp_{DEAD}_a").mkdir()
    os.replace(d / "step_00000006", d / f".old_{DEAD}_00000006")
    (d / f".tmp_{os.getpid()}_live").mkdir()
    (d / ".foreign").mkdir()
    return d


def test_readers_equal_jax_on_the_same_directories(tmp_path):
    a = _scenes(tmp_path / "a")
    b = tmp_path / "b"
    shutil.copytree(a.parent, b)
    b = b / "ck"
    steps = sorted(p.name for p in a.iterdir() if p.name.startswith("step_"))
    assert [ckpt.is_intact(a / s) for s in steps] == \
        [jckpt.is_intact(a / s) for s in steps] == [True, False, False,
                                                    False, False]
    assert ckpt.latest_step(a) == jckpt.latest_step(a) == 1
    assert ckpt.read_extra(a, 1) == jckpt.read_extra(a, 1)
    for s in (2, 3, 4, 5):
        with pytest.raises(ckpt.CheckpointCorrupt):
            ckpt.read_extra(a, s)
        with pytest.raises(jckpt.CheckpointCorrupt):
            jckpt.read_extra(a, s)
    assert ckpt.sweep_stale(a) == jckpt.sweep_stale(b) == 2
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    assert ckpt.latest_step(a) == jckpt.latest_step(b) == 6


def test_layout_and_restore_across_packages(tmp_path):
    """The same tree saved by both packages gives the same files, keys and
    bytes, and each package restores what the other wrote."""
    import dataclasses

    @dataclasses.dataclass
    class Leafs:
        a: torch.Tensor
        n: int

    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    ids = np.array([1, -1, 4], np.int32)
    tree_t = {"p": {"x": torch.from_numpy(x), "ids": torch.from_numpy(ids)},
              "l": [torch.ones(2, dtype=torch.bool)]}
    tree_j = {"p": {"x": jnp.asarray(x), "ids": jnp.asarray(ids)},
              "l": [jnp.ones(2, dtype=jnp.bool_)]}
    ckpt.save(tmp_path / "t", 3, tree_t, extra={"k": [1, 2]})
    jckpt.save(tmp_path / "j", 3, tree_j, extra={"k": [1, 2]})
    dt, dj = tmp_path / "t" / "step_00000003", tmp_path / "j" / "step_00000003"
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    for f in os.listdir(dt):
        assert (dt / f).read_bytes() == (dj / f).read_bytes(), f
    got, extra = ckpt.restore(tmp_path / "j", tree_t)
    assert extra == {"k": [1, 2]}
    for k in ("x", "ids"):
        assert torch.equal(got["p"][k], tree_t["p"][k])
        assert got["p"][k].dtype == tree_t["p"][k].dtype
    back, _ = jckpt.restore(tmp_path / "t", tree_j)
    np.testing.assert_array_equal(np.asarray(back["p"]["x"]), x)
    # dataclass fields are '.<name>' keys, as jax.tree_util names them;
    # Python numbers are leaves and come back as their template's type
    ckpt.save(tmp_path / "d", 1, {"s": Leafs(torch.zeros(2), 7)})
    assert json.loads((tmp_path / "d" / "step_00000001" /
                       "manifest.json").read_text())["keys"] == [
        "s/.a", "s/.n"]
    got, _ = ckpt.restore(tmp_path / "d", {"s": Leafs(torch.ones(2), 0)})
    assert got["s"].n == 7 and isinstance(got["s"].n, int)
    assert torch.equal(got["s"].a, torch.zeros(2))
