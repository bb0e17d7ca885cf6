"""whisper-base (encoder-decoder) and phi-3-vision-4.2b (the VLM prefix) on
the port against the JAX package, on the CPU.

Both smoke configs in float32 with JAX's weights through
``convert.params_from_jax``; tokens, frames and patch embeddings made with
numpy from a seed and given to both packages. Tolerance TOL = 2e-3, as in
tests/test_torch_lm.py; the train step holds gradients to GRAD_TOL = 3e-4
scale-relative and losses to LOSS_TOL = 1e-5 relative, as
tests/test_torch_train.py. No kernel lies on these paths: every attention
is the global flash (the encoder's and the cross-attention's non-causal),
so nothing is launched on CPU tensors or on the card.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import serving as JS
from repro.optim import adam as JO
from repro.train import trainer as JT
from repro_torch import configs as TC
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.kernels.prefix_sum import prefix_sum
from repro_torch.kernels.window_attn import window_attention
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import serving as TS
from repro_torch.optim import adam as TO
from repro_torch.train import trainer as TT

torch.set_num_threads(1)

TOL = 2e-3
GRAD_TOL = 3e-4
LOSS_TOL = 1e-5
# bf16 against an fp32 model of the same weights: the port's relative L2
# at most this factor of JAX's own bf16 model's, as test_torch_lm.py's
# BF16_FACTOR (the two round at different places)
BF16_FACTOR = 1.25
ARCHS = ["whisper-base", "phi-3-vision-4.2b"]
B, S, N = 2, 12, 4                 # batch, prompt tokens, decode steps


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _scale_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_t(tree):
    return _flat(jax.tree.map(lambda t: t.detach().float().numpy(), tree))


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32"):
    """(cfg, jcfg, JAX's params, the port's params carried from them)."""
    cfg = dataclasses.replace(TC.get_smoke_config(arch), dtype=dtype)
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return cfg, jcfg, jparams, params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), "cpu")


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """JAX's ``decode_step`` of the smoke config, jitted once a module."""
    _, jcfg, jparams, _ = _model(arch)
    return jax.jit(lambda c, t, i: JM.decode_step(jcfg, jparams, c, t, i))


@functools.lru_cache(maxsize=None)
def _jitted(jcfg):
    """JAX's forward (no remat) and prefill of ``jcfg``, jitted once (a
    compile is quicker than the eager scans' and each shape compiles
    once)."""
    return (jax.jit(lambda p, t, e: JM.forward(jcfg, p, t, remat=False,
                                               **e)),
            jax.jit(lambda p, t, e, m: JM.prefill(jcfg, p, t, max_len=m,
                                                  **e), static_argnums=3))


def _jax_forward(jcfg, jparams, tokens, extras):
    return _jitted(jcfg)[0](jparams, tokens, extras)


def _jax_prefill(jcfg, jparams, tokens, extras, max_len):
    return _jitted(jcfg)[1](jparams, tokens, extras, max_len)


def _extras(cfg, seed, b=B):
    """numpy stub inputs: whisper's frames (B, enc_seq, d), the VLM's
    patch embeddings (B, n_img, d), at about the token embeddings' scale
    for the patches and the sinusoid table's for the frames."""
    rng = np.random.default_rng(seed)
    if cfg.n_enc_layers:
        return {"frame_embeds": rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {"patch_embeds": (0.5 * rng.standard_normal(
        (b, cfg.n_img_tokens, cfg.d_model))).astype(np.float32)}


def _n_img(extras):
    return extras["patch_embeds"].shape[1] if "patch_embeds" in extras \
        else 0


def _t(extras, dtype=torch.float32):
    return {k: torch.tensor(v).to(dtype) for k, v in extras.items()}


def _tokens(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


# -- layers ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_match_jax(dtype):
    """The smoke widths, whisper-base's decoder context (448) and its
    encoder's 1536 frames: fp32 within 3e-4 absolute (an angle pos * freq
    rounds differently once the two exps differ by an ulp: 1.2e-4 at
    position 1535), bf16 within one bf16 ulp of a value <= 1 (2^-8)."""
    tol = 3e-4 if dtype == "float32" else 2.0 ** -8
    for s, d in ((16, 64), (7, 3), (448, 512), (1536, 512)):
        want = np.asarray(JL.sinusoidal_positions(s, d, jnp.dtype(dtype))
                          .astype(jnp.float32))
        got = TL.sinusoidal_positions(s, d, getattr(torch, dtype), "cpu")
        assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)


def test_encoder_matches_jax():
    """``_run_encoder`` (sinusoid added, bidirectional layers, final norm)
    within TOL of JAX's, with and without remat."""
    cfg, jcfg, jparams, params = _model("whisper-base")
    frames = _extras(cfg, 1)["frame_embeds"]
    want = jax.jit(lambda p, f: JM._run_encoder(jcfg, p, f, False))(
        jparams, frames)
    for remat in (False, True):
        got = TM._run_encoder(cfg, params, torch.tensor(frames), remat)
        _close(got, want)


def test_cross_attention_matches_jax():
    """``_cross_attention`` of layer 1 over a JAX encoder output: 12
    queries against 16 frames, non-causal, at chunks that split both sides
    (q_chunk 5 -> 4 of 12, k_chunk 6 -> 4 of 16)."""
    cfg, jcfg, jparams, params = _model("whisper-base")
    cfg = dataclasses.replace(cfg, attn_q_chunk=5, attn_k_chunk=6)
    jcfg = dataclasses.replace(jcfg, attn_q_chunk=5, attn_k_chunk=6)
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc_h = np.asarray(JM._run_encoder(jcfg, jparams, _extras(cfg, 1)[
        "frame_embeds"], False))
    want = JM._cross_attention(jcfg, jax.tree.map(lambda a: a[1],
                                                  jparams["cross_attn"]),
                               h, enc_h)
    xp = TM._index(params["cross_attn"], 1)
    k, v = TM._cross_kv(cfg, xp["attn"], torch.tensor(enc_h))
    assert k.shape == (B, cfg.n_kv_heads, cfg.enc_seq, cfg.head_dim)
    _close(TM._cross_attention(cfg, xp, torch.tensor(h), k, v), want)


# -- forward, prefill, decode ------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_caches_match_jax(arch):
    """The param tree and the cache spec as JAX's; forward and prefill
    logits (n_img + S rows for the VLM) and the prefill's k/v (the VLM's
    starting at the prefix, padded to max_len) and whisper's
    cross_k/cross_v within TOL of JAX's; no kernel launched."""
    cfg, jcfg, jparams, params = _model(arch)
    mine = TM.init_params(cfg, 0, device="cpu")
    assert {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(jparams)[0]} == \
        {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
         jax.tree_util.tree_flatten_with_path(mine)[0]}
    extras = _extras(cfg, 1)
    n_img, max_len = _n_img(extras), _n_img(extras) + S + N
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            JM.cache_spec(jcfg, B, max_len).items()} == \
        {k: (shape, jnp.dtype(str(dt).removeprefix("torch."))) for k, (
            shape, dt) in TM.cache_spec(cfg, B, max_len).items()}
    prompt = _tokens(cfg, 3, S)
    j_logits, _ = _jax_forward(jcfg, jparams, prompt, extras)
    j_pre, j_cache = _jax_prefill(jcfg, jparams, prompt, extras, max_len)
    prefix_sum.launches = window_attention.launches = 0
    t_logits, aux = TM.forward(cfg, params, torch.tensor(prompt),
                               **_t(extras))
    t_pre, t_cache = TM.prefill(cfg, params, torch.tensor(prompt),
                                max_len=max_len, **_t(extras))
    assert prefix_sum.launches == window_attention.launches == 0
    assert t_logits.shape == (B, n_img + S, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(t_logits, j_logits)
    _close(t_pre, j_pre)
    assert t_cache.keys() == j_cache.keys() == (
        {"k", "v", "cross_k", "cross_v"} if cfg.n_enc_layers else {"k", "v"})
    for name in j_cache:
        assert tuple(t_cache[name].shape) == j_cache[name].shape, name
        _close(t_cache[name], j_cache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    """N decode steps at n_img + S + t from the prefill's cache: the logits
    and the caches after them within TOL of JAX's, and of the port's own
    no-cache forward over (prefix, prompt, fed tokens)."""
    cfg, jcfg, jparams, params = _model(arch)
    extras = _extras(cfg, 4)
    start = _n_img(extras) + S
    tokens = _tokens(cfg, 5, S + N)
    _, j_cache = _jax_prefill(jcfg, jparams, tokens[:, :S], extras,
                              start + N)
    _, t_cache = TM.prefill(cfg, params, torch.tensor(tokens[:, :S]),
                            max_len=start + N, **_t(extras))
    j_step = _jax_step(arch)
    full, _ = TM.forward(cfg, params, torch.tensor(tokens), **_t(extras))
    for n in range(N):
        tok = tokens[:, S + n:S + n + 1]
        j_lg, j_cache = j_step(j_cache, tok, jnp.int32(start + n))
        t_lg, t_cache = TM.decode_step(cfg, params, t_cache,
                                       torch.tensor(tok), start + n)
        _close(t_lg, j_lg)
        _close(t_lg[:, 0], full[:, start + n])
    for name in j_cache:
        _close(t_cache[name], j_cache[name])


def _greedy_compared(t_tok, j_tok, step_logits):
    """Assert the port's greedy tokens equal ``j_tok`` at every step whose
    top-2 margin in JAX's ``step_logits`` is above TOL, up to the first
    that is not; -> the steps compared."""
    compared = 0
    for n, lg in enumerate(step_logits):
        top2 = np.sort(lg, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0]).min() <= TOL:
            break
        np.testing.assert_array_equal(t_tok[:, n].numpy(), j_tok[:, n])
        compared += 1
    return compared


def test_whisper_generate_matches_jax():
    """``generate`` with frames: the prefill logits within TOL of JAX's
    and the greedy tokens JAX's ``generate``'s, step by step as far as
    JAX's top-2 margins allow (its decode starts at S: no prefix)."""
    cfg, jcfg, jparams, params = _model("whisper-base")
    extras = _extras(cfg, 6)
    prompt = _tokens(cfg, 7, S)
    j_tok, j_logits = JS.generate(jcfg, jparams, prompt, N, **extras)
    t_tok, t_logits = TS.generate(cfg, params, torch.tensor(prompt), N,
                                  **_t(extras))
    _close(t_logits, j_logits)
    j_tok = np.asarray(j_tok)
    assert t_tok.shape == j_tok.shape == (B, N)
    _, j_cache = _jax_prefill(jcfg, jparams, prompt, extras, S + N)
    step_logits = [np.asarray(j_logits[:, -1])]
    for n in range(N - 1):
        lg, j_cache = _jax_step("whisper-base")(j_cache, j_tok[:, n:n + 1],
                                                jnp.int32(S + n))
        step_logits.append(np.asarray(lg[:, 0]))
    assert _greedy_compared(t_tok, j_tok, step_logits) >= 1


def test_vlm_generate_decodes_after_the_prefix(monkeypatch):
    """The VLM's ``generate`` sizes its cache n_img + S + N and decodes at
    n_img + S + t: its tokens are those of a greedy loop of JAX's
    ``prefill`` + ``decode_step`` at those indices, and its first decode
    logits agree with JAX's ``forward`` over (patches, prompt, token).
    JAX's own ``generate`` decodes from S with a cache of S + N rows (a
    reference gap, ROADMAP): its first decode logits, rebuilt with its
    bookkeeping, depart from that forward."""
    cfg, jcfg, jparams, params = _model("phi-3-vision-4.2b")
    extras = _extras(cfg, 8)
    n_img = _n_img(extras)
    prompt = _tokens(cfg, 9, S)
    seen = []
    decode = TM.decode_step

    def recording(cfg_, params_, cache, tokens, cache_index):
        lg, cache = decode(cfg_, params_, cache, tokens, cache_index)
        seen.append((cache_index, cache["k"].shape[3], lg.clone()))
        return lg, cache

    monkeypatch.setattr(TM, "decode_step", recording)
    t_tok, t_logits = TS.generate(cfg, params, torch.tensor(prompt), N,
                                  **_t(extras))
    assert t_logits.shape == (B, n_img + S, cfg.vocab_size)
    assert [(i, m) for i, m, _ in seen] == [
        (n_img + S + n, n_img + S + N) for n in range(N - 1)]

    # the reference: JAX's prefill + decode_step at n_img + S + t, greedy
    j_step = _jax_step("phi-3-vision-4.2b")
    j_pre, j_cache = _jax_prefill(jcfg, jparams, prompt, extras,
                                  n_img + S + N)
    _close(t_logits, j_pre)
    tok = np.asarray(jnp.argmax(j_pre[:, -1:], -1), np.int32)
    j_tok, step_logits = [tok], [np.asarray(j_pre[:, -1])]
    for n in range(N - 1):
        lg, j_cache = j_step(j_cache, tok, jnp.int32(n_img + S + n))
        step_logits.append(np.asarray(lg[:, 0]))
        tok = np.asarray(jnp.argmax(lg, -1), np.int32)
        j_tok.append(tok)
    assert _greedy_compared(t_tok, np.concatenate(j_tok, 1),
                            step_logits) >= 1

    # the first decode step against JAX's forward over (patches, prompt,
    # the first token); JAX's generate's step (cache S + N, index S) off it
    first = t_tok[:, :1].numpy().astype(np.int32)
    j_fwd, _ = _jax_forward(jcfg, jparams,
                            np.concatenate([prompt, first], 1), extras)
    want = np.asarray(j_fwd[:, -1])
    _close(seen[0][2][:, 0], want)
    _, g_cache = _jax_prefill(jcfg, jparams, prompt, extras, S + N)
    g_lg, _ = j_step(g_cache, first, jnp.int32(S))
    assert np.abs(np.asarray(g_lg[:, 0]) - want).max() > 100 * TOL
    # and JAX's generate takes that step's token
    j_gen, _ = JS.generate(jcfg, jparams, prompt, 2, **extras)
    top2 = np.sort(np.asarray(g_lg[:, 0]), -1)[:, -2:]
    if (top2[:, 1] - top2[:, 0]).min() > TOL:
        np.testing.assert_array_equal(np.asarray(j_gen)[:, 1],
                                      np.asarray(jnp.argmax(g_lg[:, 0], -1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_as_close_to_fp32_as_jax(arch):
    """``smoke()`` in bf16 (frames in bf16, as ``cfg.dtype``): the port's
    forward and prefill each within BF16_FACTOR x JAX's bf16 relative L2 to
    an fp32 model of the same weights on the same (bf16-rounded) inputs."""
    cfg, jcfg, jparams, params = _model(arch, "bfloat16")
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    extras = {k: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
              for k, v in _extras(cfg, 10).items()}
    j_extras = {k: jnp.asarray(v, jnp.bfloat16) for k, v in extras.items()}
    prompt = _tokens(cfg, 11, S)
    j_logits, _ = _jax_forward(jcfg, jparams, prompt, j_extras)
    f_logits, _ = _jax_forward(jcfg32, j32, prompt, extras)
    rel_jax = _rel_l2(j_logits.astype(jnp.float32), f_logits)
    t_logits, _ = TM.forward(cfg, params, torch.tensor(prompt),
                             **_t(extras, torch.bfloat16))
    t_pre, _ = TM.prefill(cfg, params, torch.tensor(prompt),
                          max_len=S + _n_img(extras) + 2,
                          **_t(extras, torch.bfloat16))
    assert t_logits.dtype == torch.bfloat16
    for what, got in (("forward", t_logits), ("prefill", t_pre)):
        rel = _rel_l2(got.float(), f_logits)
        assert 0.0 < rel_jax and rel <= BF16_FACTOR * rel_jax, \
            f"{what}: port {rel:.5f} vs JAX {rel_jax:.5f} from fp32"


def test_frames_in_another_dtype_raise():
    """JAX promotes fp32 frames against bf16 weights; the port's matmuls
    would refuse mixed dtypes, so it raises naming the dtypes rather than
    cast. A missing frame input and another family's extra raise too."""
    cfg16, _, _, params16 = _model("whisper-base", "bfloat16")
    cfg, _, _, params = _model("whisper-base")
    prompt = torch.tensor(_tokens(cfg, 12, 4))
    frames = _t(_extras(cfg, 12))
    with pytest.raises(TypeError, match=r"frame_embeds are torch\.float32.*"
                                        r"torch\.bfloat16"):
        TM.forward(cfg16, params16, prompt, **frames)
    with pytest.raises(TypeError, match=r"torch\.bfloat16.*torch\.float32"):
        TM.prefill(cfg, params, prompt, **_t(_extras(cfg, 12),
                                             torch.bfloat16))
    with pytest.raises(ValueError, match="needs frame_embeds"):
        TM.forward(cfg, params, prompt)
    with pytest.raises(ValueError, match=r"takes no \['patch_embeds'\]"):
        TM.forward(cfg, params, prompt, patch_embeds=frames["frame_embeds"],
                   **frames)
    vcfg, _, _, vparams = _model("phi-3-vision-4.2b")
    with pytest.raises(ValueError, match=r"takes no \['frame_embeds'\]"):
        TM.prefill(vcfg, vparams, prompt, **frames)


def test_vlm_prefix_sizes_the_chunks_as_jax():
    """A prompt of 4096 tokens after 64 patches is 4160 rows, whose flash
    chunk is 416 in both packages (JAX's _chunk_for: the largest divisor
    <= 512); and at the smoke size, 8 patches + 12 tokens = 20 rows at
    q/k chunks of 8 -> 5, the forward matches JAX's within TOL."""
    assert TA._chunk_for(4160, 512) == JA._chunk_for(4160, 512) == 416
    cfg, jcfg, jparams, params = _model("phi-3-vision-4.2b")
    cfg = dataclasses.replace(cfg, attn_q_chunk=8, attn_k_chunk=8)
    jcfg = dataclasses.replace(jcfg, attn_q_chunk=8, attn_k_chunk=8)
    assert TA._chunk_for(cfg.n_img_tokens + S, 8) == 5
    extras = _extras(cfg, 13)
    prompt = _tokens(cfg, 14, S)
    j_logits, _ = _jax_forward(jcfg, jparams, prompt, extras)
    t_logits, _ = TM.forward(cfg, params, torch.tensor(prompt),
                             **_t(extras))
    _close(t_logits, j_logits)


# -- training ----------------------------------------------------------------


def _batch(cfg, seed, b=B):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (b, S + 1), dtype=np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            **_extras(cfg, seed, b)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """The loss (the VLM's logits n_img rows longer than its labels, the
    prefix scoring nothing; whisper's gradient reaching the encoder through
    the cross-attention) and every gradient leaf against
    ``jax.value_and_grad(make_loss_fn)``, then one ``make_train_step`` step
    against JAX's jitted step: the loss within 1e-4 relative, the params
    within GRAD_TOL scale-relative (leaves that start at zero held by their
    gradients, as tests/test_torch_train.py says why). JAX's step is its
    ``adam_update`` of its own gradients above, which is what its
    ``make_train_step`` does at one microbatch without compression."""
    cfg, jcfg, jparams, params = _model(arch)
    params = TO.tree_map(torch.clone, params)
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    zero_init = {k for k, v in _flat(jparams).items() if not v.any()}
    batch = _batch(cfg, 15)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _t(batch)
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jcfg), has_aux=True))(jparams, jb)
    live = TO.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    loss, _ = TT.make_loss_fn(cfg)(live, tb)
    grads = iter(torch.autograd.grad(loss, list(TO.tree_leaves(live))))
    got = _flat_t(TO.tree_map(lambda _: next(grads), live))
    want = _flat(jgrads)
    assert abs(float(loss.detach()) - float(jloss)) <= \
        LOSS_TOL * abs(float(jloss))
    assert got.keys() == want.keys()
    for key in want:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key
    if cfg.n_enc_layers:
        assert np.abs(got["['enc_layers']['attn']['wq']"]).max() > 0

    jopt = JO.init_opt_state(jparams, JO.AdamConfig(**opt_cfg))
    opt = opt_state_from_jax(cfg, jax.tree.map(np.asarray, jopt), "cpu")
    jnew, _ = JO.adam_update(jparams, jgrads, jopt, JO.AdamConfig(**opt_cfg))
    m, new, _ = TT.make_train_step(cfg, TO.AdamConfig(**opt_cfg))(
        params, opt, tb)
    assert abs(float(m["loss"]) - float(jloss)) <= 1e-4 * abs(float(jloss))
    got, want = _flat_t(new), _flat(jnew)
    assert zero_init < want.keys()
    for key in want.keys() - zero_init:
        assert _scale_rel(got[key], want[key]) <= GRAD_TOL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_split_the_extras(arch):
    """microbatches=2 on a batch of 4 splits the frames or patches with the
    tokens: the step's params equal ``adam_update`` of the mean of the two
    half-batch gradients (each half with its own extras) bit for bit, and
    its loss is the mean of the halves' losses."""
    cfg, _, _, params = _model(arch)
    opt_cfg = dict(lr=1e-3, total_steps=64, warmup_steps=2)
    batch = _batch(cfg, 16, b=4)
    tb = _t(batch)
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    loss_fn = TT.make_loss_fn(cfg)
    halves, losses = [], []
    for half in (slice(0, 2), slice(2, 4)):
        live = TO.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = loss_fn(live, {k: v[half] for k, v in tb.items()})
        gs = iter(torch.autograd.grad(loss, list(TO.tree_leaves(live))))
        halves.append(TO.tree_map(lambda _: next(gs), live))
        losses.append(float(loss.detach()))
    mean = TO.tree_map(lambda a, b: (a + b) / 2, *halves)
    tcfg = TO.AdamConfig(**opt_cfg)
    want, _ = TO.adam_update(TO.tree_map(torch.clone, params), mean,
                             TO.init_opt_state(params, tcfg), tcfg)
    m, got, _ = TT.make_train_step(cfg, tcfg, microbatches=2)(
        TO.tree_map(torch.clone, params), TO.init_opt_state(params, tcfg), tb)
    got_flat = _flat_t(got)
    for key, w in _flat_t(want).items():
        np.testing.assert_array_equal(got_flat[key], w, err_msg=key)
    assert abs(float(m["loss"]) - sum(losses) / 2) <= \
        LOSS_TOL * abs(float(m["loss"]))
