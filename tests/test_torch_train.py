"""The port's training path against the JAX package, on the CPU.

Inputs and weights are made with numpy (or by JAX's ``init_params``) from
a seed and go to both packages. On CPU tensors the port's local layers run
kernel G's plain version forward and kernel Gb's plain version backward,
where JAX differentiates ``window_attention_blocked`` with XLA; the global
layers run both packages' ``flash_attention`` with its custom backward.
gemma2-2b ``smoke()`` in float32, S = 16 > window 8, so every local layer
takes G's path. Each test states its tolerance: 3e-4 scale-relative for
gradients (the fp32 kernel tolerance of tests/test_kernels.py), 1e-5
relative for a loss, 1e-6 relative for one AdamW update.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import pipeline as JD
from repro.models import attention as JA
from repro.models import model as JM
from repro.optim import adam as JO
from repro.train import trainer as JT
from repro_torch import configs as TC
from repro_torch.ckpt import checkpoint as C
from repro_torch.convert import (data_state_from_dict, opt_state_from_jax,
                                 params_from_jax)
from repro_torch.data import DataConfig, DataState, Pipeline, batch_at
from repro_torch.kernels import _build
from repro_torch.kernels._common import MAX_SMEM
from repro_torch.kernels.window_attn import (BWD_TILE, bwd_smem_bytes,
                                             window_attention,
                                             window_attention_bwd,
                                             window_attention_bwd_plain,
                                             window_attention_plain)
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.optim import adam as TO
from repro_torch.train import trainer as TT

torch.set_num_threads(1)

GRAD_TOL = 3e-4
LOSS_TOL = 1e-5
ADAM_TOL = 1e-6
B, S = 2, 16                 # gemma2 smoke: S = 16 > window 8


def _rand(rng, *shape, scale=1.0):
    return rng.standard_normal(shape).astype(np.float32) * scale


def _scale_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# -- flash attention's backward ------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("softcap", [0.0, 50.0], ids=["cap0", "cap50"])
@pytest.mark.parametrize("h,kh,s,d,q_chunk,k_chunk", [
    (4, 2, 32, 16, 8, 16), (4, 4, 24, 8, 24, 8), (8, 1, 32, 16, 16, 8),
    (2, 2, 20, 8, 7, 5)], ids=["gqa2", "mha-one-q-chunk", "gqa8",
                               "chunks-not-dividing"])
def test_flash_attention_grads_match_jax(causal, softcap, h, kh, s, d,
                                         q_chunk, k_chunk):
    """dq, dk, dv of the port's flash_attention against jax.grad of JAX's
    (its custom_vjp), scale-relative GRAD_TOL."""
    rng = np.random.default_rng(s * h + d)
    q, k = _rand(rng, 2, h, s, d, scale=3.0), _rand(rng, 2, kh, s, d,
                                                     scale=3.0)
    v, do = _rand(rng, 2, kh, s, d), _rand(rng, 2, h, s, d)

    def f(q, k, v):
        return jnp.sum(JA.flash_attention(q, k, v, causal, softcap, q_chunk,
                                          k_chunk) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(a, grad=True) for a in (q, k, v)]
    out = TA.flash_attention(*ts, causal, softcap, q_chunk, k_chunk)
    got = torch.autograd.grad(out, ts, _t(do))
    for name, g, w in zip("qkv", got, want):
        assert _scale_rel(g.numpy(), w) <= GRAD_TOL, name


def test_softcap_grad_is_jax_derivative_clipped():
    s = np.array([-60.0, -49.0, 0.0, 10.0, 49.9, -1e30], np.float32)
    got = TA._softcap_grad(torch.tensor(s), 50.0).numpy()
    want = np.asarray(JA._softcap_grad(jnp.clip(jnp.asarray(s), -50, 50),
                                       50.0))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert torch.equal(TA._softcap_grad(torch.tensor(s), 0.0),
                       torch.ones(6))


# -- kernel G's backward (its plain version on the CPU) ------------------------


@pytest.mark.parametrize("h,kh,window,softcap", [
    (4, 2, 8, 50.0), (4, 4, 16, 0.0), (8, 1, 4, 50.0)],
    ids=["gqa2-cap", "mha", "gqa8-cap"])
def test_window_backward_matches_jax_blocked(h, kh, window, softcap):
    """window_attention's backward on CPU tensors against jax.grad of JAX's
    window_attention_blocked (S a multiple of the window), scale-relative
    GRAD_TOL."""
    rng = np.random.default_rng(window + h)
    s, d = 32, 16
    q, k = _rand(rng, 2, h, s, d, scale=3.0), _rand(rng, 2, kh, s, d,
                                                     scale=3.0)
    v, do = _rand(rng, 2, kh, s, d), _rand(rng, 2, h, s, d)

    def f(q, k, v):
        return jnp.sum(JA.window_attention_blocked(
            q, k, v, window=window, softcap=softcap) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(a, grad=True) for a in (q, k, v)]
    out = window_attention(*ts, window=window, blk=8, softcap=softcap)
    got = torch.autograd.grad(out, ts, _t(do))
    for name, g, w in zip("qkv", got, want):
        assert _scale_rel(g.numpy(), w) <= GRAD_TOL, name


@pytest.mark.parametrize("s,window,blk,softcap,h,kh", [
    (40, 13, 8, 0.0, 4, 2), (64, 8, 16, 50.0, 4, 4), (24, 100, 8, 50.0, 2, 1),
    (48, 1, 16, 50.0, 4, 2), (40, 40, 40, 0.0, 6, 3)],
    ids=["ragged-window", "window-tiles", "window-past-s", "window1",
         "one-block"])
def test_window_backward_matches_autograd_of_plain(s, window, blk, softcap,
                                                   h, kh):
    """window_attention_bwd's plain version against torch.autograd through
    window_attention_plain, scale-relative GRAD_TOL; at window 1 dq and dk
    are zero (one visible key a row), so they are held to 1e-6 of |dv|."""
    rng = np.random.default_rng(s + window)
    d = 8
    q, k = _rand(rng, 1, h, s, d, scale=3.0), _rand(rng, 1, kh, s, d,
                                                     scale=3.0)
    v, do = _rand(rng, 1, kh, s, d), _rand(rng, 1, h, s, d)
    ts = [_t(a, grad=True) for a in (q, k, v)]
    out = window_attention_plain(*ts, window=window, blk=blk,
                                 softcap=softcap)
    want = torch.autograd.grad(out, ts, _t(do))
    got = window_attention_bwd(*(t.detach() for t in ts), out.detach(),
                               _t(do), window=window, softcap=softcap)
    assert [g.dtype for g in got] == [torch.float32] * 3
    if window == 1:
        floor = float(want[2].abs().max())
        for g, w in zip(got[:2], want[:2]):
            assert float((g - w).abs().max()) <= 1e-6 * floor
        got, want = got[2:], want[2:]
    for g, w in zip(got, want):
        assert _scale_rel(g.numpy(), w.numpy()) <= GRAD_TOL


def test_window_backward_bf16_keeps_dtypes_and_raises_on_bad_shapes():
    rng = np.random.default_rng(0)
    q = torch.tensor(_rand(rng, 1, 4, 16, 8)).bfloat16()
    k = torch.tensor(_rand(rng, 1, 2, 16, 8)).bfloat16()
    dq, dk, dv = window_attention_bwd_plain(q, k, k, q, q, window=4)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    assert dk.shape == k.shape and dq.shape == q.shape
    with pytest.raises(ValueError, match="q's shape"):
        window_attention_bwd(q, k, k, q[:, :2], q, window=4)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        window_attention_bwd(meta, k.to("meta"), k.to("meta"), meta, meta,
                             window=4)
    assert window_attention_bwd.launches == 0


def test_window_backward_shared_memory_matches_the_cuda_source():
    """bwd_smem_bytes is the CUDA source's dkdv_smem (its largest launch):
    at D = 256 the figure its header states, and within a block's 227 KB
    for every head dim the wrapper takes; the tile rows are the source's."""
    src = (_build.CSRC / "window_attn_bwd.cu").read_text()
    assert f"constexpr int kBQ = {BWD_TILE};" in src
    assert f"constexpr int kBK = {BWD_TILE};" in src
    assert "(141,568 B" in src and bwd_smem_bytes(256) == 141_568
    assert all(bwd_smem_bytes(d) <= MAX_SMEM for d in range(1, 257))


# -- cross entropy -------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "masked-labels", "longer-logits",
                                  "mask"])
def test_cross_entropy_matches_jax(case):
    """Value within LOSS_TOL relative and d/dlogits within GRAD_TOL
    scale-relative of JAX's cross_entropy."""
    rng = np.random.default_rng(3)
    logits = _rand(rng, 2, 12, 40, scale=4.0)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = None
    if case == "masked-labels":
        labels[0, :5] = -1
    if case == "longer-logits":
        labels = labels[:, 4:]
    if case == "mask":
        mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    jl = jnp.asarray(labels)
    jm = None if mask is None else jnp.asarray(mask)
    want, wgrad = jax.value_and_grad(
        lambda x: JT.cross_entropy(x, jl, jm))(jnp.asarray(logits))
    x = _t(logits, grad=True)
    got = TT.cross_entropy(x, _t(labels),
                           None if mask is None else _t(mask))
    (g,) = torch.autograd.grad(got, (x,))
    got = float(got.detach())
    assert abs(got - float(want)) <= LOSS_TOL * abs(float(want))
    assert _scale_rel(g.numpy(), wgrad) <= GRAD_TOL


@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_chunked_cross_entropy_matches_jax(n_chunks):
    """Value and d/d(x, head) against JAX's chunked_cross_entropy with the
    logit softcap, labels -1 in places; 3 chunks of S = 12 fall back to
    JAX's largest divisor."""
    rng = np.random.default_rng(n_chunks)
    x, head = _rand(rng, 2, 12, 16), _rand(rng, 16, 40, scale=2.0)
    labels = rng.integers(0, 40, (2, 12)).astype(np.int32)
    labels[1, 3:6] = -1

    def jf(x, head):
        return JT.chunked_cross_entropy(
            lambda l: 30.0 * jnp.tanh(l / 30.0), x, jnp.asarray(labels),
            head, n_chunks=n_chunks)
    want, wgrads = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(head))
    tx, th = _t(x, grad=True), _t(head, grad=True)
    got = TT.chunked_cross_entropy(lambda l: torch.tanh(l / 30.0) * 30.0,
                                   tx, _t(labels), th, n_chunks=n_chunks)
    grads = torch.autograd.grad(got, (tx, th))
    got = float(got.detach())
    assert abs(got - float(want)) <= LOSS_TOL * abs(float(want))
    for g, w in zip(grads, wgrads):
        assert _scale_rel(g.numpy(), w) <= GRAD_TOL


# -- the gemma2 smoke model ----------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    cfg = TC.get_smoke_config("gemma2-2b")
    jcfg = jax_smoke_config("gemma2-2b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    return cfg, jcfg, jparams, tree, batch


def _tbatch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return _flat(jax.tree.map(lambda t: t.detach().float().numpy(), tree))


def test_gemma_loss_and_grads_match_jax(smoke):
    """The port's loss within LOSS_TOL relative and every gradient leaf
    within GRAD_TOL scale-relative of jax.value_and_grad of JAX's
    make_loss_fn."""
    cfg, jcfg, jparams, tree, batch = smoke
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = TO.tree_map(lambda t: t.requires_grad_(),
                         params_from_jax(cfg, tree, "cpu"))
    loss, parts = TT.make_loss_fn(cfg)(params, _tbatch(batch))
    leaves = list(TO.tree_leaves(params))
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = TO.tree_map(lambda _: next(grads), params)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        LOSS_TOL * abs(float(jloss))
    assert float(parts["aux"]) == 0.0
    got, want = _flat_t(grads), _flat(jgrads)
    assert got.keys() == want.keys()
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


def _mean_half_grads(cfg, params, batch):
    loss_fn = TT.make_loss_fn(cfg)
    halves = []
    for half in (slice(0, B // 2), slice(B // 2, B)):
        live = TO.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = loss_fn(live, {k: v[half] for k, v in batch.items()})
        gs = iter(torch.autograd.grad(loss, list(TO.tree_leaves(live))))
        halves.append(TO.tree_map(lambda _: next(gs), live))
    return TO.tree_map(lambda a, b: (a + b) / 2, *halves)


def test_microbatches_average_the_half_batch_grads(smoke):
    """microbatches=2 updates with the mean of the two half-batch gradients:
    its params equal adam_update of that mean bit for bit."""
    cfg, _, _, tree, batch = smoke
    opt_cfg = TO.AdamConfig(lr=1e-3, total_steps=64, warmup_steps=2)
    tb = _tbatch(batch)
    params = params_from_jax(cfg, tree, "cpu")
    want_grads = _mean_half_grads(cfg, params, tb)
    want, _ = TO.adam_update(TO.tree_map(torch.clone, params), want_grads,
                             TO.init_opt_state(params, opt_cfg), opt_cfg)
    step = TT.make_train_step(cfg, opt_cfg, microbatches=2)
    metrics, got, opt = step(params, TO.init_opt_state(params, opt_cfg), tb)
    assert int(opt["step"]) == 1 and float(metrics["aux"]) == 0.0
    for key, w in _flat_t(want).items():
        np.testing.assert_array_equal(_flat_t(got)[key], w, err_msg=key)


def test_remat_equals_no_remat_bit_for_bit(smoke):
    cfg, _, _, tree, batch = smoke
    params = params_from_jax(cfg, tree, "cpu")
    out = {}
    for remat in (True, False):
        live = TO.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = TT.make_loss_fn(cfg, remat=remat)(live, _tbatch(batch))
        out[remat] = (loss, torch.autograd.grad(
            loss, list(TO.tree_leaves(live))))
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)


def test_train_steps_match_jax_jitted_step(smoke):
    """Three make_train_step steps from one AdamW state (JAX's, carried by
    convert.opt_state_from_jax) on the same batches: losses within 1e-4
    relative of JAX's jitted step, params after the last step within
    GRAD_TOL scale-relative, step counts equal."""
    cfg, jcfg, jparams, tree, batch = smoke
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    jopt = JO.init_opt_state(jparams, JO.AdamConfig(**opt_cfg))
    params = params_from_jax(cfg, tree, "cpu")
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jopt), "cpu")
    jstep = jax.jit(JT.make_train_step(jcfg, JO.AdamConfig(**opt_cfg)))
    step = TT.make_train_step(cfg, TO.AdamConfig(**opt_cfg))
    rng = np.random.default_rng(7)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        jm, jparams, jopt = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        m, params, opt = step(params, opt, _tbatch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"])), i
        assert np.isfinite(float(m["grad_norm"]))
    assert int(opt["step"]) == int(jopt["step"]) == 3
    got, want = _flat_t(params), _flat(jparams)
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "codeqwen1.5-7b",
                                  "starcoder2-3b"])
def test_dense_arch_train_steps_match_jax(arch):
    """The dense archs' ``smoke()`` (every layer global: QKV bias, an untied
    LM head, LayerNorm, the ungated GELU) on JAX's weights: the first
    step's loss and every gradient leaf against ``jax.value_and_grad``,
    then three steps from JAX's AdamW state with losses within 1e-4
    relative of JAX's jitted step and the params after the last step
    within GRAD_TOL scale-relative. A leaf that starts at zero (the QKV
    and norm biases, the rms norms' scales) is held by its gradient only:
    its first AdamW updates are ~lr * sign(g) an element, so where an
    element's gradient is near 0 its update measures AdamW's division,
    not the model (a K bias, whose gradient RoPE alone keeps from 0,
    moves by 3.5e-4 of its scale for gradients that agree to 2e-6)."""
    cfg, jcfg = TC.get_smoke_config(arch), jax_smoke_config(arch)
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jopt = JO.init_opt_state(jparams, JO.AdamConfig(**opt_cfg))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jopt), "cpu")
    zero_init = {k for k, v in _flat(jparams).items() if not v.any()}
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1), dtype=np.int32)
        batches.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})

    (_, _), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batches[0].items()})
    live = TO.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = TT.make_loss_fn(cfg)(live, _tbatch(batches[0]))
    grads = iter(torch.autograd.grad(loss, list(TO.tree_leaves(live))))
    got, want = (_flat_t(TO.tree_map(lambda _: next(grads), live)),
                 _flat(jgrads))
    assert got.keys() == want.keys()
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key

    jstep = jax.jit(JT.make_train_step(jcfg, JO.AdamConfig(**opt_cfg)))
    step = TT.make_train_step(cfg, TO.AdamConfig(**opt_cfg))
    for i, b in enumerate(batches):
        jm, jparams, jopt = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        m, params, opt = step(params, opt, _tbatch(b))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            1e-4 * abs(float(jm["loss"])), i
    got, want = _flat_t(params), _flat(jparams)
    assert zero_init and zero_init < want.keys()
    for key in want.keys() - zero_init:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


@pytest.mark.parametrize("arch", ["grok-1-314b", "zamba2-1.2b"])
def test_moe_and_hybrid_train_step_matches_jax(arch):
    """grok-1-314b's ``smoke()`` (MoE: the loss adds 0.01 x the aux loss,
    the gradient flows through the dispatch to the router and the experts)
    and zamba2-1.2b's (Mamba-2 layers and the shared attention block,
    whose gradient sums over its invocations) on JAX's weights: the loss,
    the aux loss and every gradient leaf against ``jax.value_and_grad``,
    then one ``make_train_step`` step against JAX's jitted step: the loss
    within 1e-4 relative, the params within GRAD_TOL scale-relative
    (leaves that start at zero held by their gradients, as
    ``test_dense_arch_train_steps_match_jax`` says why)."""
    cfg, jcfg = TC.get_smoke_config(arch), jax_smoke_config(arch)
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    zero_init = {k for k, v in _flat(jparams).items() if not v.any()}
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (B, S + 1),
                                              dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jcfg), has_aux=True))(jparams, jb)
    live = TO.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, parts = TT.make_loss_fn(cfg)(live, _tbatch(batch))
    # zamba2's Mamba layers have a norm2 the loss does not read (JAX's
    # init makes it too): a zero gradient, as JAX's
    grads = iter(torch.autograd.grad(loss, list(TO.tree_leaves(live)),
                                     materialize_grads=True))
    got, want = (_flat_t(TO.tree_map(lambda _: next(grads), live)),
                 _flat(jgrads))
    assert abs(float(loss.detach()) - float(jloss)) <= \
        LOSS_TOL * abs(float(jloss))
    assert abs(float(parts["aux"].detach()) - float(jparts["aux"])) <= \
        1e-6 * max(1.0, abs(float(jparts["aux"])))
    assert (float(parts["aux"].detach()) > 0) == bool(cfg.n_experts)
    assert got.keys() == want.keys()
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key

    jopt = JO.init_opt_state(jparams, JO.AdamConfig(**opt_cfg))
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jopt), "cpu")
    jm, jparams, _ = jax.jit(JT.make_train_step(
        jcfg, JO.AdamConfig(**opt_cfg)))(jparams, jopt, jb)
    m, params, _ = TT.make_train_step(cfg, TO.AdamConfig(**opt_cfg))(
        params, opt, _tbatch(batch))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        1e-4 * abs(float(jm["loss"]))
    got, want = _flat_t(params), _flat(jparams)
    assert zero_init < want.keys()
    for key in want.keys() - zero_init:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


def test_compressed_step_matches_jax(smoke):
    """compress_pod_grads=True: one step's params within GRAD_TOL
    scale-relative of JAX's (int8 values and scales are bit-equal between
    the packages, tests/test_torch_dist_fault.py)."""
    cfg, jcfg, jparams, tree, batch = smoke
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    jopt = JO.init_opt_state(jparams, JO.AdamConfig(**opt_cfg))
    _, jnew, _ = jax.jit(JT.make_train_step(
        jcfg, JO.AdamConfig(**opt_cfg), compress_pod_grads=True))(
        jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(cfg, tree, "cpu")
    step = TT.make_train_step(cfg, TO.AdamConfig(**opt_cfg),
                              compress_pod_grads=True)
    _, params, _ = step(params, TO.init_opt_state(
        params, TO.AdamConfig(**opt_cfg)), _tbatch(batch))
    got, want = _flat_t(params), _flat(jnew)
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


def test_eval_step_matches_loss_fn(smoke):
    cfg, _, _, tree, batch = smoke
    params = params_from_jax(cfg, tree, "cpu")
    m = TT.make_eval_step(cfg)(params, _tbatch(batch))
    loss, parts = TT.make_loss_fn(cfg)(params, _tbatch(batch))
    assert torch.equal(m["loss"], loss) and torch.equal(m["ce"], parts["ce"])
    assert not m["loss"].requires_grad


def test_loss_decreases_on_a_memorized_batch():
    """The twin of tests/test_train_ckpt_fault.py::test_loss_decreases: 30
    steps on one batch take the loss down by more than 0.5."""
    cfg = TC.get_smoke_config("gemma2-2b")
    opt_cfg = TO.AdamConfig(lr=1e-3, total_steps=64, warmup_steps=2)
    params = TM.init_params(cfg, 0, device="cpu")
    opt = TO.init_opt_state(params, opt_cfg)
    step = TT.make_train_step(cfg, opt_cfg)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tokens, labels = batch_at(data, 0, device="cpu")
    losses = []
    for _ in range(30):
        m, params, opt = step(params, opt, {"tokens": tokens,
                                            "labels": labels})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


# -- AdamW ---------------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adam_update_matches_jax(moment_dtype):
    """Four updates from the same grads and state: params, m and v within
    ADAM_TOL relative (of each leaf's scale), step equal; clipping active
    (|g| > 1), decay on the matrix and not on the vector."""
    rng = np.random.default_rng(1)
    params = {"w": _rand(rng, 8, 16), "n": {"scale": _rand(rng, 16)}}
    grads = {"w": _rand(rng, 8, 16, scale=3.0), "n": {"scale": _rand(rng,
                                                                     16)}}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=moment_dtype)
    jcfg, tcfg = JO.AdamConfig(**kw), TO.AdamConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    js = JO.init_opt_state(jp, jcfg)
    tp = TO.tree_map(torch.tensor, params)
    ts = TO.init_opt_state(tp, tcfg)
    for _ in range(4):
        jp, js = JO.adam_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                jcfg)
        tp, ts = TO.adam_update(tp, TO.tree_map(torch.tensor, grads), ts,
                                tcfg)
    assert int(ts["step"]) == int(js["step"]) == 4
    assert ts["m"]["w"].dtype == getattr(torch, moment_dtype)
    for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        g, w = _flat_t(got), _flat(want)
        for key in w:
            assert _scale_rel(g[key], w[key]) <= ADAM_TOL, key
    assert float(TO.global_norm(TO.tree_map(torch.tensor, grads))) == \
        pytest.approx(float(JO.global_norm(jax.tree.map(jnp.asarray,
                                                        grads))), rel=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_at_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(TO.lr_at(TO.AdamConfig(**kw), torch.tensor(step)))
        want = float(JO.lr_at(JO.AdamConfig(**kw), jnp.int32(step)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_opt_state_from_jax_carries_every_leaf(smoke):
    cfg, jcfg, jparams, tree, batch = smoke
    jopt = JO.init_opt_state(jparams, JO.AdamConfig(moment_dtype="bfloat16"))
    jopt = dict(jopt, step=jnp.int32(5))
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jopt), "cpu")
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 5
    assert opt["m"]["embed"].dtype == torch.bfloat16
    assert _flat_t(opt["v"]).keys() == _flat(jparams).keys()
    with pytest.raises(ValueError, match="AdamW state"):
        opt_state_from_jax(cfg, {"m": tree}, "cpu")


# -- the data pipeline ---------------------------------------------------------


def test_batch_at_deterministic_in_range_and_host_sharded():
    """The twin of tests/test_train_ckpt_fault.py::
    test_data_pipeline_determinism_and_sharding."""
    data = DataConfig(vocab_size=100, seq_len=16, global_batch=8)
    t1, l1 = batch_at(data, 5, device="cpu")
    t2, l2 = batch_at(data, 5, device="cpu")
    assert torch.equal(t1, t2) and torch.equal(l1, l2)
    assert t1.dtype == torch.int32 and tuple(t1.shape) == (8, 16)
    assert int(t1.min()) >= 0 and int(t1.max()) < 100
    assert torch.equal(t1[:, 1:], l1[:, :-1])
    assert not torch.equal(t1, batch_at(data, 6, device="cpu")[0])
    a, _ = batch_at(data, 5, host_index=0, n_hosts=2, device="cpu")
    b, _ = batch_at(data, 5, host_index=1, n_hosts=2, device="cpu")
    assert tuple(a.shape) == (4, 16) and not torch.equal(a, b)
    assert torch.equal(a, batch_at(data, 5, host_index=0, n_hosts=2,
                                   device="cpu")[0])
    other = dataclasses.replace(data, stream_id=1)
    assert not torch.equal(t1, batch_at(other, 5, device="cpu")[0])
    with pytest.raises(ValueError, match="does not split"):
        batch_at(data, 0, n_hosts=3, device="cpu")


def test_pipeline_cursor_round_trips_and_resumes():
    data = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    it = Pipeline(data, device="cpu")
    first = [next(it)[0] for _ in range(3)]
    state = data_state_from_dict(JD.DataState(step=1).to_dict())
    assert state == DataState(step=1)
    assert data_state_from_dict(it.state.to_dict()) == DataState(step=3)
    resumed = Pipeline(data, state, device="cpu")
    assert torch.equal(next(resumed)[0], first[1])
    assert resumed.state.step == 2


def test_data_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    data = DataConfig(vocab_size=10, seq_len=4, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_at(data, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(data)


# -- the launcher --------------------------------------------------------------


def test_launcher_restart_is_bit_identical(tmp_path, monkeypatch):
    """The twin of tests/test_train_ckpt_fault.py::
    test_restart_is_bitwise_deterministic through the launcher: a run whose
    watchdog fires once at step 3 restarts from its step-2 checkpoint with
    the data cursor and ends bit-equal to an uninterrupted run."""
    from repro_torch.dist.fault import StragglerDetected, StragglerWatchdog
    from repro_torch.launch import train as LT
    argv = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps",
            "5", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--log-every", "100"]
    LT.main(argv + ["--ckpt-dir", str(tmp_path / "a")])

    fired = []

    class FiresOnce(StragglerWatchdog):
        def observe(self, step_seconds):
            super().observe(step_seconds)
            if len(self.history) == 3 and not fired:   # step index 2
                fired.append(True)
                raise StragglerDetected("injected")

    monkeypatch.setattr(LT, "StragglerWatchdog", FiresOnce)
    LT.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert fired
    assert C.latest_step(tmp_path / "a") == C.latest_step(tmp_path / "b") == 5
    cfg = TC.get_smoke_config("gemma2-2b")
    like = TM.init_params(cfg, 0, device="cpu")
    like = (like, TO.init_opt_state(like, TO.AdamConfig()))
    (pa, oa), ea = C.restore(tmp_path / "a", like)
    (pb, ob), eb = C.restore(tmp_path / "b", like)
    assert ea == eb == {"data_step": 5}
    for a, b in zip(TO.tree_leaves({"p": pa, "o": oa}),
                    TO.tree_leaves({"p": pb, "o": ob})):
        assert torch.equal(a, b)


def test_checkpoint_keeps_bf16_leaves_bit_for_bit(tmp_path):
    t = torch.tensor([1.0, -2.5, 3.14159, 1e-3, 6e4]).bfloat16()
    C.save(tmp_path, 1, {"w": t, "step": torch.tensor(3, dtype=torch.int32)})
    got, _ = C.restore(tmp_path, {"w": torch.zeros(5, dtype=torch.bfloat16),
                                  "step": torch.tensor(0,
                                                       dtype=torch.int32)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], t)
    assert int(got["step"]) == 3
