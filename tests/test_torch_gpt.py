"""PyTorch port, GPT: trunk forward / prefill / decode step, latent
re-forward, the plain version of the decode-trunk kernel against the TPU
kernel in interpret mode, sampling with shared Gumbel noise, and greedy
codes from the whole decode, all held against the JAX package on the same
weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import gpt2 as jax_gpt2
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.ops import sampling as jax_sampling
from indextts_tpu.ops.pallas import decode_layer as jax_decode_layer
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import gpt2, unified_voice as uv
from indextts_tpu_torch.ops import sampling
from indextts_tpu_torch.ops.cuda import decode_layer

TINY = dict(model_dim=64, layers=2, heads=4, max_mel_tokens=48, max_text_tokens=30,
            number_text_tokens=40, number_mel_codes=50, start_mel_token=46,
            stop_mel_token=47,
            condition_module=dict(output_size=32, linear_units=64, attention_heads=4,
                                  num_blocks=2, perceiver_mult=2))
# fp32 on both sides: matmuls and softmax differ only in summation order
TOL = 1e-5


def numpy_params(shapes, seed, weight_std):
    """A parameter tree of the JAX package's layout (`shapes`, from
    jax.eval_shape of its init) filled from a numpy seed."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['scale']") or name.endswith("['gamma']"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if len(shape) == 1 or name.endswith(("_b']", "['bias']", "['b']")):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (weight_std(shape) * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def gpt_numpy_params(jcfg, seed=0):
    shapes = jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg))
    return numpy_params(shapes, seed, lambda s: 1.0 / np.sqrt(s[-2]))


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    tcfg = GPTConfig.from_dict(TINY)
    np_params = gpt_numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, from_jax.gpt_params_from_numpy(np_params, tcfg)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_trunk_forward_prefill_and_decode_step_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    size = jax_gpt2.GPT2Size(2, 64, 4)
    tsize = gpt2.GPT2Size(2, 64, 4)
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((2, 9, 64)).astype(np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, :3] = 0                                   # left padding on row 1
    ref = jax_gpt2.forward(jp["gpt"], jnp.asarray(emb), jnp.asarray(mask), size)
    got = gpt2.forward(tp["gpt"], torch.from_numpy(emb), torch.from_numpy(mask), tsize)
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL, rtol=0)

    rh, rcache = jax_gpt2.prefill(jp["gpt"], jnp.asarray(emb), jnp.asarray(mask), size, 16)
    gh, gcache = gpt2.prefill(tp["gpt"], torch.from_numpy(emb), torch.from_numpy(mask),
                              tsize, 16)
    np.testing.assert_allclose(_np(gh), _np(rh), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gcache.k), _np(rcache.k), atol=TOL, rtol=0)

    tok = rng.standard_normal((2, 1, 64)).astype(np.float32)
    full = np.zeros((2, 16), np.int32)
    full[:, :10] = np.concatenate([mask, np.ones((2, 1), np.int32)], axis=1)
    rh, rcache = jax_gpt2.decode_step(jp["gpt"], jnp.asarray(tok), rcache, jnp.int32(9),
                                      jnp.asarray(full), size)
    gh, gcache = gpt2.decode_step(tp["gpt"], torch.from_numpy(tok), gcache, 9,
                                  torch.from_numpy(full), tsize)
    np.testing.assert_allclose(_np(gh), _np(rh), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gcache.v), _np(rcache.v), atol=TOL, rtol=0)


def test_latent_forward_matches_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((2, 32, 64)).astype(np.float32)
    text = rng.integers(2, 40, (2, 16)).astype(np.int32)
    codes = rng.integers(0, 46, (2, 24)).astype(np.int32)
    tl, cl = np.asarray([16, 9], np.int32), np.asarray([24, 13], np.int32)
    ref = jax_uv.latent_forward(jp, jcfg, jnp.asarray(cond), jnp.asarray(text),
                                jnp.asarray(tl), jnp.asarray(codes), jnp.asarray(cl))
    got = uv.latent_forward(tp, tcfg, torch.from_numpy(cond), torch.from_numpy(text).long(),
                            torch.from_numpy(tl).long(), torch.from_numpy(codes).long(),
                            torch.from_numpy(cl).long())
    assert got.shape == (2, 24, 64)
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("position,holes", [(37, False), (300, False), (290, True)])
def test_decode_trunk_plain_matches_tpu_kernel_interpret(setup, position, holes):
    """T = 512 streams as two 256-slot chunks in the TPU kernel: positions in
    the first and the second chunk, and a mask with holes inside
    [0, position] (left padding and a gap)."""
    _, _, jp, tp = setup
    T = 512
    rng = np.random.default_rng(position)
    k = rng.standard_normal((2, T, 64)).astype(np.float32)
    v = rng.standard_normal((2, T, 64)).astype(np.float32)
    hidden = rng.standard_normal((1, 1, 64)).astype(np.float32)
    mask = np.zeros((1, T), np.int32)
    mask[0, : position + 1] = 1
    if holes:
        mask[0, 5:21] = 0
        mask[0, 250:270] = 0
    ref, rk, rv = jax_decode_layer.fused_decode_trunk_flat(
        jp["gpt"], jnp.asarray(hidden), jnp.asarray(k), jnp.asarray(v),
        jnp.int32(position), jnp.asarray(mask), heads=4, interpret=True)
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    before = decode_layer.fused_decode_trunk_flat.launches
    got, gk, gv = decode_layer.fused_decode_trunk_flat(
        tp["gpt"], torch.from_numpy(hidden), kt, vt, position, torch.from_numpy(mask), 4)
    assert decode_layer.fused_decode_trunk_flat.launches == before == 0
    assert gk is kt and gv is vt                     # rows written in place
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gk), _np(rk), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gv), _np(rv), atol=TOL, rtol=0)


def _tied_bf16_logits(rng, B: int, V: int) -> np.ndarray:
    """N(0, 3) logits rounded to bf16 (the type of a bf16 engine's head), and
    each row's largest value planted again at three other columns."""
    logits = torch.from_numpy(3 * rng.standard_normal((B, V))).bfloat16().float().numpy()
    for b in range(B):
        logits[b, rng.choice(V, 3, replace=False)] = logits[b].max()
    return logits


@pytest.mark.parametrize("top_k,top_p,penalty,ties", [
    pytest.param(30, 0.8, 10.0, False, id="30-0.8-10.0"),
    pytest.param(5, 1.0, 1.0, False, id="5-1.0-1.0"),
    pytest.param(0, 0.5, 2.0, False, id="0-0.5-2.0"),
    # a shortlist with ties: JAX's order (lower index first) decides which
    # of equal logits the same Gumbel draw picks
    pytest.param(30, 0.8, 10.0, True, id="bf16_ties-30-0.8-10.0"),
    pytest.param(30, 0.8, 1.0, True, id="bf16_ties-30-0.8-1.0")])
def test_sample_step_with_shared_gumbel_matches_jax(top_k, top_p, penalty, ties):
    rng = np.random.default_rng(top_k + int(10 * penalty))
    if ties:
        B, V = 8, 8194
        logits = _tied_bf16_logits(rng, B, V)
        presence = rng.random((B, V)) < 0.05
        finished = np.zeros(B, bool)
        finished[-1] = True
    else:
        B, V = 3, 50
        rng = np.random.default_rng(top_k)
        logits = (2 * rng.standard_normal((B, V))).astype(np.float32)
        presence = rng.random((B, V)) < 0.2
        finished = np.asarray([False, False, True])
    for step in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(7), step)
        k = top_k if 0 < top_k < V else V
        gumbel = np.asarray(jax.random.gumbel(key, (B, k), jnp.float32))
        kw = dict(stop_token=47, temperature=0.9, top_k=top_k, top_p=top_p,
                  repetition_penalty=penalty)
        rt, rp, rf = jax_sampling.sample_step(key, jnp.asarray(logits), jnp.asarray(presence),
                                              jnp.asarray(finished), **kw)
        gt, gp, gf = sampling.sample_step(torch.tensor(logits), torch.tensor(presence),
                                          torch.tensor(finished), gumbel=torch.tensor(gumbel),
                                          **kw)
        np.testing.assert_array_equal(_np(gt), _np(rt))
        np.testing.assert_array_equal(_np(gp), _np(rp))
        np.testing.assert_array_equal(_np(gf), _np(rf))
        presence, finished = _np(rp), _np(rf)
        logits = np.roll(logits, 3, axis=1)


def test_greedy_inference_speech_codes_match_jax(setup):
    jcfg, tcfg, jp, tp = setup
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((1, 32, 64)).astype(np.float32)
    prep = uv.prepare_text_prompt([rng.integers(2, 40, (6,))], 0, 1)
    tokens = np.pad(prep.text_tokens, ((0, 0), (8, 0)))   # left pad: mask holes
    mask = np.pad(prep.attn_text, ((0, 0), (8, 0)))
    kw = dict(max_new=20, do_sample=False, repetition_penalty=1.5)
    ref = jax_uv.inference_speech(jp, jcfg, jnp.asarray(cond), jnp.asarray(tokens),
                                  jnp.asarray(mask), jax.random.PRNGKey(0),
                                  cache_dtype=jnp.float32, **kw)
    got = uv.inference_speech(tp, tcfg, torch.from_numpy(cond),
                              torch.from_numpy(tokens).long(), torch.from_numpy(mask), None,
                              cache_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(_np(got.codes), _np(ref.codes))
    np.testing.assert_array_equal(_np(got.lengths), _np(ref.lengths))
    assert got.steps == min(int(_np(ref.lengths)[0]) + 1, 20) - 1


def test_unported_decode_modes_raise(setup):
    """Batched rows and guidance, once refused, now run: B = 2 rows with a
    [1, ...] conditioning, and guided rows at B = 1 and 2 (2B physical
    rows), each with codes [B, max_new] and lengths [B].  Their codes are
    held against JAX's in tests/test_torch_infer_fast.py."""
    _, tcfg, _, tp = setup
    tokens = torch.full((2, 4), 3, dtype=torch.long)
    mask = torch.ones(2, 4, dtype=torch.int32)
    kw = dict(max_new=6, do_sample=False, cache_dtype=torch.float32)
    for B, cfg_scale in ((2, 1.0), (1, 2.0), (2, 2.0)):
        r = uv.inference_speech(tp, tcfg, torch.zeros(1, 32, 64), tokens[:B], mask[:B],
                                cfg_scale=cfg_scale, **kw)
        assert tuple(r.codes.shape) == (B, 6) and tuple(r.lengths.shape) == (B,)
        assert tuple(r.finished.shape) == (B,) and 0 <= r.steps <= 5


def test_head_split_wrapper_matches_tpu_wrapper_interpret(setup):
    """fused_decode_trunk over the head-split cache [L, 1, H, T, hd] against
    the TPU package's wrapper in interpret mode (fp32, tolerance 1e-5); the
    returned cache keeps the layout, and unflatten_cache inverts
    flatten_cache."""
    _, _, jp, tp = setup
    T, position, heads = 64, 41, 4
    rng = np.random.default_rng(17)
    k = rng.standard_normal((2, 1, heads, T, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1, heads, T, 16)).astype(np.float32)
    hidden = rng.standard_normal((1, 1, 64)).astype(np.float32)
    mask = np.zeros((1, T), np.int32)
    mask[0, : position + 1] = 1
    mask[0, 2:7] = 0
    ref, rcache = jax_decode_layer.fused_decode_trunk(
        jp["gpt"], jnp.asarray(hidden), jax_gpt2.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.int32(position), jnp.asarray(mask), heads=heads, interpret=True)
    cache = gpt2.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    got, gcache = decode_layer.fused_decode_trunk(tp["gpt"], torch.from_numpy(hidden), cache,
                                                  position, torch.from_numpy(mask), heads)
    assert tuple(gcache.k.shape) == k.shape and decode_layer.fused_decode_trunk_flat.launches == 0
    np.testing.assert_allclose(_np(got), _np(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gcache.k), _np(rcache.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gcache.v), _np(rcache.v), atol=TOL, rtol=0)
    back = decode_layer.unflatten_cache(*decode_layer.flatten_cache(cache), heads)
    assert torch.equal(back.k, cache.k) and torch.equal(back.v, cache.v)
