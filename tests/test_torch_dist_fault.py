"""The port's ``dist.fault`` and ``dist.compress`` against the JAX
package's (``tests/test_train_ckpt_fault.py``): the straggler watchdog, the
restart driver with its backoff, the restart over a corrupt checkpoint,
the elastic restore onto a template's devices; int8 values and scales
equal to JAX's, and error feedback converging."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.dist import compress as jcompress
from repro_torch.ckpt import checkpoint as C
from repro_torch.dist import compress
from repro_torch.dist.fault import (FaultConfig, StragglerDetected,
                                    StragglerWatchdog, elastic_restore,
                                    run_with_restarts)

torch.set_num_threads(1)


def test_watchdog_and_restart_driver(tmp_path):
    wd = StragglerWatchdog(deadline_s=0.05)
    wd.observe(0.01)
    with pytest.raises(StragglerDetected):
        wd.observe(0.2)

    state = {"fail_at": 2, "restarts": 0}

    def train_loop(start):
        for step in range(start, 5):
            if step == state["fail_at"]:
                state["fail_at"] = -1
                state["restarts"] += 1
                C.save(tmp_path, step, {"x": torch.ones(3)})
                raise StragglerDetected("simulated straggler")
        return 5

    out = run_with_restarts(train_loop, FaultConfig(ckpt_dir=str(tmp_path)))
    assert out == 5 and state["restarts"] == 1


def test_watchdog_history_is_bounded():
    wd = StragglerWatchdog(deadline_s=10.0, history_len=16)
    for i in range(100):
        wd.observe(0.001 * i)
    assert len(wd.history) == 16
    np.testing.assert_allclose(list(wd.history),
                               [0.001 * i for i in range(84, 100)])


def test_restart_driver_backs_off_and_gives_up(tmp_path):
    sleeps = []
    state = {"failures": 3}

    def train_loop(start):
        if state["failures"] > 0:
            state["failures"] -= 1
            raise RuntimeError("transient backend error")
        return "done"

    cfg = FaultConfig(ckpt_dir=str(tmp_path), backoff_s=0.1,
                      backoff_cap_s=0.25)
    assert run_with_restarts(train_loop, cfg, sleep=sleeps.append) == "done"
    np.testing.assert_allclose(sleeps, [0.1, 0.2, 0.25])   # capped at 3rd
    with pytest.raises(RuntimeError, match="always"):
        run_with_restarts(
            lambda start: (_ for _ in ()).throw(RuntimeError("always")),
            FaultConfig(ckpt_dir=str(tmp_path), max_restarts=2),
            sleep=sleeps.append)


def test_restart_rides_over_a_corrupt_checkpoint(tmp_path):
    tree = {"x": torch.arange(4.0), "y": torch.ones(2)}
    C.save(tmp_path, 1, tree)
    C.save(tmp_path, 2, tree)
    (pathlib.Path(tmp_path) / "step_00000002" / "y.npy").unlink()
    calls = []

    def train_loop(start):
        calls.append(start)
        if len(calls) == 1:
            C.restore(tmp_path, tree, step=2)   # raises CheckpointCorrupt
        return start

    assert run_with_restarts(train_loop,
                             FaultConfig(ckpt_dir=str(tmp_path))) == 1
    assert calls == [1, 1]


def test_elastic_restore_puts_leaves_on_the_template(tmp_path):
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    C.save(tmp_path, 3, tree, extra={"data_step": 3})
    template = {"w": torch.zeros(2, 3, dtype=torch.float64),
                "b": torch.zeros(3)}
    got, extra = elastic_restore(tmp_path, tree, lambda: template)
    assert extra["data_step"] == 3 and got["w"].dtype == torch.float64
    assert torch.equal(got["w"], tree["w"].double())
    got, _ = elastic_restore(tmp_path, tree, lambda: None, step=3)
    assert torch.equal(got["b"], tree["b"])


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 5)).astype(np.float32) * 3,
            "layers": [rng.standard_normal(7).astype(np.float32),
                       [rng.standard_normal(3).astype(np.float32) * 1e-3]]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, fn) for v in tree)
    return fn(tree)


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_values_and_scales_equal_jax(seed):
    g = _grads(seed)
    q, s = compress.compress_grads_int8(_to(g, torch.from_numpy))
    jq, js = jcompress.compress_grads_int8(_to(g, jnp.asarray))
    flat = lambda t: [np.asarray(x) for x in _leaves(t)]  # noqa: E731
    for a, b in zip(flat(_to(q, lambda t: t.numpy())), flat(jq)):
        assert a.dtype == np.int8
        np.testing.assert_array_equal(a, b)
    for a, b in zip(flat(_to(s, lambda t: t.numpy())), flat(js)):
        np.testing.assert_array_equal(a, b)
    back = compress.decompress_grads_int8(q, s)
    jback = jcompress.decompress_grads_int8(jq, js)
    for a, b in zip(flat(_to(back, lambda t: t.numpy())), flat(jback)):
        np.testing.assert_array_equal(a, b)
    # JAX's tree utilities take a tuple for a pair; the port keeps tuples
    q, s = compress.compress_grads_int8((torch.ones(2), [torch.zeros(1)]))
    assert isinstance(q, tuple) and isinstance(q[1], list)
    assert q[0].tolist() == [127, 127]
    assert s[1][0] == torch.tensor(1e-12)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):           # JAX's trees order keys so
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_error_feedback_converges_and_equals_jax():
    """SGD on a quadratic with int8-compressed grads and error feedback
    reaches the target (JAX's test), step for step with JAX's."""
    target = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    t_target, j_target = torch.from_numpy(target), jnp.asarray(target)
    x, jx = {"w": torch.zeros(32)}, {"w": jnp.zeros(32)}
    res = compress.init_residual(x)
    jres = jcompress.init_residual(jx)
    for _ in range(300):
        g, res = compress.compress_with_feedback(
            {"w": 2 * (x["w"] - t_target)}, res)
        jg, jres = jcompress.compress_with_feedback(
            {"w": 2 * (jx["w"] - j_target)}, jres)
        x = {"w": x["w"] - 0.05 * g["w"]}
        jx = {"w": jx["w"] - 0.05 * jg["w"]}
    np.testing.assert_allclose(x["w"].numpy(), target, atol=1e-2)
    np.testing.assert_allclose(x["w"].numpy(), np.asarray(jx["w"]),
                               rtol=1e-5, atol=1e-6)
