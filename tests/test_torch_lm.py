"""The port's LM serving path against the JAX package, on the CPU.

gemma2-2b ``smoke()`` in float32, with JAX's weights carried over by
``convert.params_from_jax``; inputs from a numpy seed. The port's local
layers run kernel G's plain version where JAX runs
``window_attention_blocked``. Tolerance 2e-3, as tests/test_models.py's
prefill-vs-forward check. In bfloat16 (the card's dtype) the port is held
to JAX through an fp32 model of the same weights (``BF16_FACTOR``).

The MoE, SSM and hybrid archs (grok-1-314b, arctic-480b, mamba2-130m,
zamba2-1.2b) are held the same way at 3e-4 in float32 and within
``NEW_BF16_FACTOR`` of JAX's own bf16 distance in bfloat16; the SSM
archs' decode steps start from the state the prompt's replay builds, as
``generate`` does in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import serving as JS
from repro_torch import configs as TC
from repro_torch.convert import params_from_jax
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.kernels.window_attn import window_attention
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serving as TS

torch.set_num_threads(1)

TOL = 2e-3
B, S, N_DECODE = 2, 32, 4          # S = 32 > window 8: every local layer
PORTED = ["gemma2-2b", "qwen1.5-0.5b", "codeqwen1.5-7b", "starcoder2-3b",
          "grok-1-314b", "arctic-480b", "mamba2-130m", "zamba2-1.2b",
          "phi-3-vision-4.2b", "whisper-base"]
# MoE (grok: 4 experts; arctic: 8 with the dense residual MLP), SSM and
# the hybrid with its shared attention block (5 layers, every 2: two
# invocations, the short last group without one)
NEW = ["grok-1-314b", "arctic-480b", "mamba2-130m", "zamba2-1.2b"]
NEW_TOL = 3e-4
# every layer global: QKV bias (qwen, codeqwen), an untied LM head
# (codeqwen), LayerNorm with bias, GQA 2 and the ungated GELU (starcoder2)
DENSE = ["qwen1.5-0.5b", "codeqwen1.5-7b", "starcoder2-3b"]


@pytest.fixture(scope="module")
def setup():
    cfg = TC.get_smoke_config("gemma2-2b")
    jcfg = jax_smoke_config("gemma2-2b")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(cfg, tree, "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + N_DECODE),
                          dtype=np.int32)
    return cfg, jcfg, jparams, params, tokens


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", PORTED)
def test_config_matches_jax(arch):
    from repro.configs import get_config as jax_config
    full = TC.get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_config(arch))
    assert dataclasses.asdict(TC.get_smoke_config(arch)) == \
        dataclasses.asdict(jax_smoke_config(arch))
    assert full.param_count() == jax_config(arch).param_count()


def test_param_tree_matches_jax(setup):
    cfg, jcfg, jparams, params, _ = setup
    mine = TM.init_params(cfg, 0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert len(got) == len(want)
    for path, leaf in want:
        t = got[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32


def test_params_from_jax_keeps_bf16_bits():
    a = np.asarray(jnp.asarray([1.0, -2.5, 3.14159, 1e-3], jnp.bfloat16))
    cfg = TC.get_smoke_config("gemma2-2b")
    t = params_from_jax(cfg, {"embed": a, "final_norm": {"scale": a},
                              "layers": {}}, "cpu")["embed"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(cfg, {"embed": a}, "cpu")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["rms_norm", "layer_norm", "rope",
                                  "act_silu", "act_gelu", "mlp_gated",
                                  "mlp_plain", "qkv_project",
                                  "out_project", "embed_tokens"])
def test_layer_function_matches_jax(name):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 16)
    if name == "rms_norm":
        s = _rand(rng, 16)
        got, want = TL.rms_norm(torch.tensor(x), torch.tensor(s)), \
            JL.rms_norm(x, s)
    elif name == "layer_norm":
        s, b = _rand(rng, 16), _rand(rng, 16)
        got = TL.layer_norm(torch.tensor(x), torch.tensor(s), torch.tensor(b))
        want = JL.layer_norm(x, s, b)
    elif name == "rope":
        q = _rand(rng, 2, 3, 8, 16)
        pos = np.arange(5, 13, dtype=np.int32)
        got = TL.rope(torch.tensor(q), torch.tensor(pos), 10_000.0)
        want = JL.rope(q, pos, 10_000.0)
    elif name.startswith("act"):
        kind = name.split("_")[1]
        got, want = TL._act(torch.tensor(x) * 3, kind), JL._act(x * 3, kind)
    elif name.startswith("mlp"):
        p = {"w_up": _rand(rng, 16, 24) * 0.3,
             "w_down": _rand(rng, 24, 16) * 0.3}
        if name == "mlp_gated":
            p["w_gate"] = _rand(rng, 16, 24) * 0.3
        got = TL.mlp(torch.tensor(x), {k: torch.tensor(v)
                                       for k, v in p.items()}, "gelu")
        want = JL.mlp(x, p, "gelu")
    elif name == "qkv_project":
        p = {"wq": _rand(rng, 16, 4 * 8), "wk": _rand(rng, 16, 2 * 8),
             "wv": _rand(rng, 16, 2 * 8), "bq": _rand(rng, 32),
             "bk": _rand(rng, 16), "bv": _rand(rng, 16)}
        got = TL.qkv_project(torch.tensor(x), {k: torch.tensor(v) for k, v
                                               in p.items()}, 4, 2, 8)
        want = JL.qkv_project(x, p, 4, 2, 8)
        for g, w in zip(got, want):
            _close(g, w, 1e-5)
        return
    elif name == "out_project":
        o, wo = _rand(rng, 2, 4, 8, 8), _rand(rng, 32, 16)
        got = TL.out_project(torch.tensor(o), {"wo": torch.tensor(wo)})
        want = JL.out_project(o, {"wo": wo})
    else:
        table = _rand(rng, 50, 16)
        tok = rng.integers(0, 50, (2, 7), dtype=np.int32)
        got = TL.embed_tokens(torch.tensor(table), torch.tensor(tok), True)
        want = JL.embed_tokens(table, tok, True)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("is_local", [True, False], ids=["local", "global"])
def test_decoder_layer_matches_jax(setup, is_local):
    cfg, jcfg, jparams, params, tokens = setup
    rng = np.random.default_rng(2)
    x = _rand(rng, B, S, cfg.d_model)
    pos = np.arange(S, dtype=np.int32)
    i = 0 if is_local else 1
    jl = jax.tree.map(lambda a: a[i], jparams["layers"])
    want = JM._decoder_layer(jcfg, jl, x, pos, is_local)
    got = TM._decoder_layer(cfg, TM._index(params["layers"], i),
                            torch.tensor(x), torch.tensor(pos), is_local)
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        _close(g, w)


def test_forward_prefill_and_cache_match_jax(setup):
    cfg, jcfg, jparams, params, tokens = setup
    prompt = tokens[:, :S]
    j_logits, _ = JM.forward(jcfg, jparams, prompt, remat=False)
    j_pre, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=S + 4)
    window_attention.launches = 0
    t_logits, aux = TM.forward(cfg, params, torch.tensor(prompt))
    t_pre, t_cache = TM.prefill(cfg, params, torch.tensor(prompt),
                                max_len=S + 4)
    assert window_attention.launches == 0       # CPU tensors: plain version
    assert t_logits.shape == (B, S, cfg.vocab_size) and float(aux) == 0.0
    _close(t_logits, j_logits)
    _close(t_pre, j_pre)
    for name in ("k", "v"):
        assert tuple(t_cache[name].shape) == j_cache[name].shape
        _close(t_cache[name], j_cache[name])


def test_teacher_forced_decode_matches_jax(setup):
    cfg, jcfg, jparams, params, tokens = setup
    prompt = tokens[:, :S]
    _, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=S + N_DECODE)
    _, t_cache = TM.prefill(cfg, params, torch.tensor(prompt),
                            max_len=S + N_DECODE)
    j_step = jax.jit(lambda c, t, i: JM.decode_step(jcfg, jparams, c, t, i))
    for n in range(N_DECODE):
        tok = tokens[:, S + n:S + n + 1]
        j_lg, j_cache = j_step(j_cache, tok, jnp.int32(S + n))
        t_lg, t_cache = TM.decode_step(cfg, params, t_cache,
                                       torch.tensor(tok), S + n)
        _close(t_lg, j_lg)
    for name in ("k", "v"):
        _close(t_cache[name], j_cache[name])


def test_generate_matches_jax(setup):
    """Greedy tokens agree with JAX's at every step whose top-2 margin (in
    JAX's logits) is above the tolerance, up to the first that is not."""
    cfg, jcfg, jparams, params, tokens = setup
    prompt = tokens[:, :S]
    j_tok, j_logits = JS.generate(jcfg, jparams, prompt, N_DECODE)
    t_tok, t_logits = TS.generate(cfg, params, torch.tensor(prompt),
                                  N_DECODE)
    _close(t_logits, j_logits)
    j_tok = np.asarray(j_tok)
    assert t_tok.shape == j_tok.shape
    # JAX's logits at each generated position, teacher-forced on its tokens
    _, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=S + N_DECODE)
    step_logits = [np.asarray(j_logits[:, -1])]
    for n in range(N_DECODE - 1):
        lg, j_cache = JM.decode_step(jcfg, jparams, j_cache,
                                     j_tok[:, n:n + 1], jnp.int32(S + n))
        step_logits.append(np.asarray(lg[:, 0]))
    compared = 0
    for n, lg in enumerate(step_logits):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= TOL:
            break
        np.testing.assert_array_equal(t_tok[:, n].numpy(), j_tok[:, n])
        compared += 1
    assert compared >= 1


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_matches_jax(arch):
    """``smoke()`` in float32 on JAX's weights: the param tree, forward and
    prefill logits, the prefill's KV cache and three teacher-forced
    ``decode_step``s within TOL of JAX's; no kernel launched."""
    cfg, jcfg = TC.get_smoke_config(arch), jax_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    mine = TM.init_params(cfg, 0, device="cpu")
    assert {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]} == \
        {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
         jax.tree_util.tree_flatten_with_path(mine)[0]}
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, S + 3), dtype=np.int32)
    prompt = tokens[:, :S]
    j_logits, _ = JM.forward(jcfg, jparams, prompt, remat=False)
    j_pre, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=S + 3)
    window_attention.launches = 0
    t_logits, _ = TM.forward(cfg, params, torch.tensor(prompt))
    t_pre, t_cache = TM.prefill(cfg, params, torch.tensor(prompt),
                                max_len=S + 3)
    _close(t_logits, j_logits)
    _close(t_pre, j_pre)
    for name in ("k", "v"):
        _close(t_cache[name], j_cache[name])
    j_step = jax.jit(lambda c, t, i: JM.decode_step(jcfg, jparams, c, t, i))
    for n in range(3):
        tok = tokens[:, S + n:S + n + 1]
        j_lg, j_cache = j_step(j_cache, tok, jnp.int32(S + n))
        t_lg, t_cache = TM.decode_step(cfg, params, t_cache,
                                       torch.tensor(tok), S + n)
        _close(t_lg, j_lg)
    assert window_attention.launches == 0


# bf16 against an fp32 model of the same (bf16) weights: the port's
# relative L2 may be at most this factor of JAX's own bf16 model's. The two
# bf16 models round at different places (XLA's fusions keep some
# intermediates in fp32), so their distances to fp32 differ by up to a
# fifth (on this test's inputs the port is 0.91-1.19x JAX's 0.0090-0.0099);
# 1.25 leaves that spread and catches an error of the port's, which would
# add a term of the logits' own size.
BF16_FACTOR = 1.25


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_bf16_model_as_close_to_fp32_as_jax(setup):
    """gemma2-2b smoke() in bf16, JAX's weights rounded to bf16: the port's
    forward, prefill and 3 teacher-forced decode steps, each within
    BF16_FACTOR x JAX's bf16 relative L2 to an fp32 model of the same
    weights (JAX's forward logits are its prefill logits)."""
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-2b"),
                               dtype="bfloat16")
    cfg = dataclasses.replace(TC.get_smoke_config("gemma2-2b"),
                              dtype="bfloat16")
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), setup[2])
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 3), dtype=np.int32)
    prompt = tokens[:, :S]

    def check(what, mine, jax_bf16, fp32):
        rel_port, rel_jax = _rel_l2(mine, fp32), _rel_l2(jax_bf16, fp32)
        assert 0.0 < rel_jax and rel_port <= BF16_FACTOR * rel_jax, \
            f"{what}: port {rel_port:.5f} vs JAX {rel_jax:.5f} from fp32"

    n = S + 3
    j_pre, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=n)
    f_pre, f_cache = JM.prefill(jcfg32, j32, prompt, max_len=n)
    t_logits, _ = TM.forward(cfg, params, torch.tensor(prompt))
    assert t_logits.dtype == torch.bfloat16
    check("forward", t_logits.float(), j_pre, f_pre)
    t_pre, t_cache = TM.prefill(cfg, params, torch.tensor(prompt), max_len=n)
    check("prefill", t_pre.float(), j_pre, f_pre)
    j_step = jax.jit(lambda c, t, i: JM.decode_step(jcfg, jparams, c, t, i))
    f_step = jax.jit(lambda c, t, i: JM.decode_step(jcfg32, j32, c, t, i))
    for i in range(3):
        tok = tokens[:, S + i:S + i + 1]
        j_lg, j_cache = j_step(j_cache, tok, jnp.int32(S + i))
        f_lg, f_cache = f_step(f_cache, tok, jnp.int32(S + i))
        t_lg, t_cache = TM.decode_step(cfg, params, t_cache,
                                       torch.tensor(tok), S + i)
        check(f"decode step {i}", t_lg.float(), j_lg, f_lg)


def _jax_and_port(arch, dtype=None):
    """JAX's ``init_params`` of the smoke config (in ``dtype`` if given)
    and the port's params carried from it."""
    cfg, jcfg = TC.get_smoke_config(arch), jax_smoke_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jcfg, jparams, params


def _steps(cfg, jcfg, jparams, params, tokens, s, n):
    """(JAX's, the port's) logits of ``n`` teacher-forced decode steps
    after the prompt tokens[:, :s]: from the prefill's cache, or for
    ``ssm``/``hybrid`` from the state a replay of the prompt builds (the
    prefill's cache is zeroed in both packages)."""
    j_step = jax.jit(lambda c, t, i: JM.decode_step(jcfg, jparams, c, t, i))
    _, j_cache = JM.prefill(jcfg, jparams, tokens[:, :s], max_len=s + n)
    _, t_cache = TM.prefill(cfg, params, torch.tensor(tokens[:, :s]),
                            max_len=s + n)
    start = 0 if cfg.family in ("ssm", "hybrid") else s
    out = []
    for i in range(start, s + n):
        tok = tokens[:, i:i + 1]
        j_lg, j_cache = j_step(j_cache, tok, jnp.int32(i))
        t_lg, t_cache = TM.decode_step(cfg, params, t_cache,
                                       torch.tensor(tok), i)
        if i >= s:
            out.append((np.asarray(j_lg), t_lg))
    return out, j_cache, t_cache


@pytest.mark.parametrize("arch", NEW)
def test_moe_ssm_hybrid_arch_matches_jax(arch):
    """``smoke()`` in float32 on JAX's weights: the param tree, forward
    (and its aux loss) and prefill logits, the prefill's cache, and three
    teacher-forced decode steps and the cache after them within NEW_TOL
    of JAX's; on CPU tensors no kernel is launched."""
    cfg, jcfg, jparams, params = _jax_and_port(arch)
    mine = TM.init_params(cfg, 0, device="cpu")
    assert {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]} == \
        {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
         jax.tree_util.tree_flatten_with_path(mine)[0]}
    s = 20                             # the SSD pads 20 to chunks of 8
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, s + 3), dtype=np.int32)
    prompt = tokens[:, :s]
    j_logits, j_aux = JM.forward(jcfg, jparams, prompt, remat=False)
    j_pre, j_cache = JM.prefill(jcfg, jparams, prompt, max_len=s + 3)
    prefix_sum.launches = window_attention.launches = 0
    t_logits, t_aux = TM.forward(cfg, params, torch.tensor(prompt))
    t_pre, t_cache = TM.prefill(cfg, params, torch.tensor(prompt),
                                max_len=s + 3)
    _close(t_logits, j_logits, NEW_TOL)
    _close(t_pre, j_pre, NEW_TOL)
    assert abs(float(t_aux) - float(j_aux)) <= 1e-6 * max(1.0,
                                                          float(j_aux))
    assert (float(t_aux) > 0) == bool(cfg.n_experts)
    assert t_cache.keys() == j_cache.keys()
    for name in j_cache:
        assert tuple(t_cache[name].shape) == j_cache[name].shape, name
        _close(t_cache[name], j_cache[name], NEW_TOL)
    steps, j_cache, t_cache = _steps(cfg, jcfg, jparams, params, tokens, s,
                                     3)
    for j_lg, t_lg in steps:
        _close(t_lg, j_lg, NEW_TOL)
    for name in j_cache:
        _close(t_cache[name], j_cache[name], NEW_TOL)
    assert prefix_sum.launches == window_attention.launches == 0


# bf16 against an fp32 model of the same weights, as BF16_FACTOR: on this
# test's forward the port's relative L2 is 0.88-1.04x JAX's own bf16
# model's (zamba2-1.2b: 0.0275 against JAX's 0.0312; grok-1-314b: 0.0092
# against 0.0092); 1.5 leaves that spread and catches an error of the
# port's, which would add a term of the logits' own size
NEW_BF16_FACTOR = 1.5


@pytest.mark.parametrize("arch", NEW)
def test_moe_ssm_hybrid_bf16_as_close_to_fp32_as_jax(arch):
    """``smoke()`` in bf16 (JAX's bf16 init: the router, ``a_log``,
    ``d_skip`` and ``dt_bias`` stay fp32): forward, prefill and 3 decode
    steps each within NEW_BF16_FACTOR x JAX's bf16 relative L2 to an fp32
    model of the same weights."""
    cfg, jcfg, jparams, params = _jax_and_port(arch, "bfloat16")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    s = 16
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, s + 3), dtype=np.int32)
    prompt = tokens[:, :s]

    def check(what, mine, jax_bf16, fp32):
        rel_port, rel_jax = _rel_l2(mine, fp32), _rel_l2(jax_bf16, fp32)
        assert 0.0 < rel_jax and rel_port <= NEW_BF16_FACTOR * rel_jax, \
            f"{what}: port {rel_port:.5f} vs JAX {rel_jax:.5f} from fp32"

    j_logits, _ = JM.forward(jcfg, jparams, prompt, remat=False)
    f_logits, _ = JM.forward(jcfg32, j32, prompt, remat=False)
    t_logits, _ = TM.forward(cfg, params, torch.tensor(prompt))
    assert t_logits.dtype == torch.bfloat16
    check("forward", t_logits.float(), j_logits, f_logits)
    t_pre, _ = TM.prefill(cfg, params, torch.tensor(prompt), max_len=s + 3)
    check("prefill", t_pre.float(), j_logits, f_logits)
    steps, _, _ = _steps(cfg, jcfg, jparams, params, tokens, s, 3)
    f_steps, _, _ = _steps(cfg32, jcfg32, j32,
                           params_from_jax(cfg32, jax.tree.map(np.asarray,
                                                               j32), "cpu"),
                           tokens, s, 3)
    for i, ((j_lg, t_lg), (f_lg, _)) in enumerate(zip(steps, f_steps)):
        check(f"decode step {i}", t_lg.float(), j_lg, f_lg)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_ssm_generate_replays_the_prompt_as_jax(arch):
    """``generate`` on the SSM and hybrid archs: the prefill logits within
    NEW_TOL of JAX's, and the greedy tokens JAX's (both replay the prompt
    through decode steps) up to the first step whose top-2 margin in
    JAX's logits is within the tolerance."""
    cfg, jcfg, jparams, params = _jax_and_port(arch)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 12), dtype=np.int32)
    j_tok, j_logits = JS.generate(jcfg, jparams, prompt, N_DECODE)
    t_tok, t_logits = TS.generate(cfg, params, torch.tensor(prompt),
                                  N_DECODE)
    _close(t_logits, j_logits, NEW_TOL)
    j_tok = np.asarray(j_tok)
    assert t_tok.shape == j_tok.shape
    # JAX's logits at each generated position, teacher-forced on its tokens
    seq = np.concatenate([prompt, j_tok], axis=1)
    steps, _, _ = _steps(cfg, jcfg, jparams, params, seq, 11, N_DECODE)
    compared = 0
    for n, (lg, _) in enumerate(steps):
        lg = lg[:, 0]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= TOL:
            break
        np.testing.assert_array_equal(t_tok[:, n].numpy(), j_tok[:, n])
        compared += 1
    assert compared >= 1


def test_init_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default runs there")
    cfg = TC.get_smoke_config("gemma2-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 1, 8)
    assert TM.init_params(cfg, device="cpu")["embed"].device.type == "cpu"
