"""The port's mixture of experts (``repro_torch/models/moe.py``) against the
JAX package's ``repro/models/moe.py``, on the CPU.

The same weights (JAX's ``init_moe``, carried over as numpy) and the same
inputs (a numpy seed) go through both. JAX's routing is read from its own
``moe_mlp`` as it runs: ``exclusive_prefix_sum``, ``jax.lax.top_k`` and
``constrain`` (a no-op without a mesh, called on the sorted tokens and on
the slots) are wrapped to record their values. The routing (experts,
counts, offsets, sorted tokens, slots, ranks) is bit-equal; the output is
within 1e-5 scale-relative in fp32, the aux loss within 1e-6 relative,
the gradients of router and experts within 1e-4 scale-relative of
``jax.grad``. On CPU tensors the dispatch scan is ``paper_prefix_sum``;
kernel A is never launched.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro_torch.core.prefix import exclusive_prefix_sum, paper_prefix_sum
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.models import moe as TMOE

torch.set_num_threads(1)

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
# (experts, top_k, tokens, capacity_factor): ample capacity, the configs'
# 1.25, k = 1, and a capacity of 16 for 24 assignments an expert on
# average (some dropped)
CASES = [(4, 2, 64, 8.0), (8, 2, 96, 1.25), (4, 1, 48, 1.25),
         (8, 2, 96, 0.5)]


def _scale_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _setup(e, d=16, f=32, seed=0):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), d, f, e, jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    return jp, tp


def _x(t, d=16, seed=1):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((2, t // 2, d))).astype(np.float32)


def _jax_moe_recorded(monkeypatch, x, jp, top_k, cf):
    """JAX's ``moe_mlp`` run eagerly, with its routing recorded."""
    rec = {}
    scan, top_k_fn, constrain = (JMOE.exclusive_prefix_sum, jax.lax.top_k,
                                 JMOE.constrain)
    calls = []

    def scan_rec(counts):
        rec["counts"] = np.asarray(counts)
        rec["offsets"] = np.asarray(scan(counts))
        return rec["offsets"]

    def top_k_rec(probs, k):
        vals, idx = top_k_fn(probs, k)
        rec["gate_vals"], rec["gate_idx"] = np.asarray(vals), np.asarray(idx)
        return vals, idx

    def constrain_rec(v, *roles):
        calls.append(np.asarray(v))
        return constrain(v, *roles)

    monkeypatch.setattr(JMOE, "exclusive_prefix_sum", scan_rec)
    monkeypatch.setattr(jax.lax, "top_k", top_k_rec)
    monkeypatch.setattr(JMOE, "constrain", constrain_rec)
    out, aux = JMOE.moe_mlp(jnp.asarray(x), jp, top_k=top_k,
                            capacity_factor=cf)
    monkeypatch.undo()
    # constrain's 2nd and 3rd calls: the sorted tokens and the slots
    rec["tok"], rec["slot"] = calls[1][0], calls[2][0]
    return np.asarray(out), float(aux), rec


@pytest.mark.parametrize("e,top_k,t,cf", CASES)
def test_routing_is_bit_equal_to_jax(monkeypatch, e, top_k, t, cf):
    jp, tp = _setup(e)
    x = _x(t)
    _, _, rec = _jax_moe_recorded(monkeypatch, x, jp, top_k, cf)
    cap = TMOE.moe_capacity(t, e, top_k, cf)
    assert cap == JMOE.moe_capacity(t, e, top_k, cf)
    r = TMOE.route(torch.tensor(x).reshape(t, -1), tp["router"], top_k, cap)
    np.testing.assert_array_equal(r.gate_idx.numpy(), rec["gate_idx"][0])
    np.testing.assert_allclose(
        r.gate_vals.numpy(), rec["gate_vals"][0] /
        np.clip(rec["gate_vals"][0].sum(-1, keepdims=True), 1e-9, None),
        rtol=1e-6)
    np.testing.assert_array_equal(r.counts.numpy(), rec["counts"][0])
    np.testing.assert_array_equal(r.offsets.numpy(), rec["offsets"][0])
    np.testing.assert_array_equal(r.tok.numpy(), rec["tok"])
    np.testing.assert_array_equal(r.slot.numpy(), rec["slot"])
    kept = r.keep.numpy()
    np.testing.assert_array_equal(r.rank.numpy()[kept],
                                  rec["slot"][kept] % cap)
    assert (rec["slot"][~kept] == e * cap).all()
    assert (r.rank.numpy()[~kept] >= cap).all()
    # every assignment once: unsort inverts the stable sort
    np.testing.assert_array_equal(r.order[r.unsort].numpy(),
                                  np.arange(t * top_k))
    if cf >= 8.0:
        assert kept.all()
    if cf <= 0.5:
        assert not kept.all()


@pytest.mark.parametrize("e,top_k,t,cf", CASES)
def test_moe_mlp_and_aux_match_jax(monkeypatch, e, top_k, t, cf):
    jp, tp = _setup(e)
    x = _x(t)
    j_out, j_aux, _ = _jax_moe_recorded(monkeypatch, x, jp, top_k, cf)
    prefix_sum.launches = 0
    out, aux = TMOE.moe_mlp(torch.tensor(x), tp, top_k=top_k,
                            capacity_factor=cf)
    assert prefix_sum.launches == 0            # CPU: paper_prefix_sum
    assert out.dtype == torch.float32 and tuple(out.shape) == x.shape
    assert _scale_rel(out.numpy(), j_out) <= OUT_TOL
    assert abs(float(aux) - j_aux) <= 1e-6 * abs(j_aux)


def test_offsets_are_the_paper_scan_of_the_counts():
    _, tp = _setup(8)
    x = torch.tensor(_x(96))
    TMOE.moe_mlp.log = []
    TMOE.moe_mlp(x, tp, top_k=2, capacity_factor=1.25)
    [r] = TMOE.moe_mlp.log
    TMOE.moe_mlp.log = None
    assert r.counts.dtype == torch.int32 and int(r.counts.sum()) == 192
    assert torch.equal(r.offsets,
                       exclusive_prefix_sum(r.counts, scan=paper_prefix_sum))
    assert torch.equal(r.offsets[1:], torch.cumsum(r.counts, 0)[:-1]
                       .to(torch.int32))


def test_capacity_drops_overflow_as_jax():
    """tests/test_moe.py::test_capacity_drops_overflow on the port: every
    token routed to expert 0, a tiny capacity drops the excess (zero
    expert output), and the outputs equal JAX's at both capacities."""
    jp, _ = _setup(4, d=8, f=16)
    jp["router"] = jp["router"].at[:, 0].add(100.0)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = np.asarray(0.1 + jnp.abs(jax.random.normal(
        jax.random.PRNGKey(1), (1, 64, 8), jnp.float32)))
    for cf in (8.0, 0.1):
        want, _ = JMOE.moe_mlp(jnp.asarray(x), jp, top_k=1,
                               capacity_factor=cf)
        got, _ = TMOE.moe_mlp(torch.tensor(x), tp, top_k=1,
                              capacity_factor=cf)
        assert _scale_rel(got.numpy(), want) <= OUT_TOL, cf
    zeros = int((got == 0).all(-1).sum())
    assert zeros == 64 - TMOE.moe_capacity(64, 4, 1, 0.1)


@pytest.mark.parametrize("e,top_k,t,cf", [(4, 2, 32, 2.0), (8, 2, 64, 1.0)])
def test_grads_of_router_and_experts_match_jax(e, top_k, t, cf):
    """The gradient of (out**2).sum() + 0.01 * aux (tests/test_moe.py's
    loss) w.r.t. the router, each expert tensor and x."""
    jp, tp = _setup(e, d=8, f=16)
    x = _x(t, d=8)

    def jloss(p, xx):
        out, aux = JMOE.moe_mlp(xx, p, top_k=top_k, capacity_factor=cf)
        return (out ** 2).sum() + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, aux = TMOE.moe_mlp(tx, tp, top_k=top_k, capacity_factor=cf)
    loss = (out ** 2).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)] + [tx])
    for name, g in zip(sorted(tp), grads):
        assert float(g.abs().sum()) > 0, name
        assert _scale_rel(g.numpy(), jg[name]) <= GRAD_TOL, name
    assert _scale_rel(grads[-1].numpy(), jgx) <= GRAD_TOL


def test_init_moe_draws_jax_shapes_one_expert_at_a_time():
    jp = JMOE.init_moe(jax.random.PRNGKey(0), 16, 24, 4, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    tp = TMOE.init_moe(gen, 16, 24, 4, torch.bfloat16, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in tp.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jp.items()}
    # into given tensors: the same draws, in place
    out = {k: torch.zeros_like(tp[k]) for k in ("w_gate", "w_up", "w_down")}
    again = TMOE.init_moe(torch.Generator().manual_seed(0), 16, 24, 4,
                          torch.bfloat16, "cpu", out=out)
    for k, v in tp.items():
        assert torch.equal(again[k], v), k
    assert all(again[k] is out[k] for k in out)
    for k, std in (("w_gate", 16 ** -0.5), ("w_down", 24 ** -0.5)):
        assert 0.8 * std < float(tp[k].float().std()) < 1.2 * std
