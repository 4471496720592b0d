"""PyTorch port, beam decode: the candidate scores, the beam step with its
bank, done test and finalize, the lineage decode step, the beam-cache
permute's plain version, and whole greedy and sampled beam decodes, each
held against the JAX package on the same inputs and weights."""

import ml_dtypes  # noqa: F401  (registers the fp8 type with numpy)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import gpt2 as jax_gpt2
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.ops import beam as jax_beam
from indextts_tpu.ops.pallas import permute as jax_permute
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import gpt2, unified_voice as uv
from indextts_tpu_torch.ops import beam
from indextts_tpu_torch.ops.cuda import permute
from tests.test_torch_gpt import TINY, gpt_numpy_params

# fp32 on both sides: sums in another order
TOL = 1e-5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    tcfg = GPTConfig.from_dict(TINY)
    np_params = gpt_numpy_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, from_jax.gpt_params_from_numpy(np_params, tcfg)


@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("typical,top_k", [(False, 30), (True, 30), (False, 0)])
def test_flat_scores_match_jax(do_sample, typical, top_k):
    B, nb, V = 2, 3, 50
    rng = np.random.default_rng(top_k + 2 * typical)
    logits = (3 * rng.standard_normal((B * nb, V))).astype(np.float32)
    logits[1] = logits[0]                       # tied rows, as logits0 repeats
    presence = rng.random((B * nb, V)) < 0.2
    scores = np.asarray([[0.0, -1e9, -1e9], [-1.5, -2.0, -3.25]], np.float32)
    kw = dict(temperature=0.8, top_k=top_k, top_p=0.7, repetition_penalty=2.0,
              typical_sampling=typical, typical_mass=0.8, do_sample=do_sample)
    ref = np.asarray(jax_beam.flat_scores(jnp.asarray(logits), jnp.asarray(presence),
                                          jnp.asarray(scores), nb, **kw))
    got = _np(beam.flat_scores(torch.tensor(logits), torch.tensor(presence),
                               torch.tensor(scores), nb, **kw))
    filtered = ref == np.finfo(np.float32).min
    np.testing.assert_array_equal(got == np.finfo(np.float32).min, filtered)
    if do_sample:
        assert filtered.any()
    np.testing.assert_allclose(got[~filtered], ref[~filtered], atol=TOL, rtol=1e-6)


def _beam_stream(lp, do_sample, B=2, nb=3, V=23, steps=12, seed=3):
    """Drive both packages' beam_step / batch_done with one candidate stream
    (each side adds its own running scores) and finalize."""
    eos = V - 1
    rng = np.random.default_rng(seed + int(10 * abs(lp)))
    jstate = jax_beam.init_beam_state(B, nb, steps + 1)
    tstate = beam.init_beam_state(B, nb, steps + 1)
    jseqs = jnp.zeros((B, nb, steps + 1), jnp.int32)
    tseqs = torch.zeros(B, nb, steps + 1, dtype=torch.int32)
    jdone = jnp.zeros((B,), bool)
    tdone = torch.zeros(B, dtype=torch.bool)
    s = 0
    for s in range(steps):
        logp = np.log(rng.dirichlet(np.ones(V), size=(B, nb))).astype(np.float32)
        logp[:, :, eos] += 3.0                      # make banking events common
        if s == 0:
            logp[:, 1:] = logp[:, :1]               # the repeated first logits
        jflat = jnp.asarray(logp) + jstate.scores[:, :, None]
        tflat = torch.tensor(logp) + tstate.scores[:, :, None]
        key = jax.random.PRNGKey(100 + s)
        g = np.asarray(jax.random.gumbel(key, (B, nb * V)))
        jstate, jpar, jtok, jseqs, jbest = jax_beam.beam_step(
            key, jflat.reshape(B, nb * V), nb, jstate, jseqs, jnp.int32(s), eos, do_sample,
            length_penalty=lp, done=jdone)
        tstate, tpar, ttok, tseqs, tbest = beam.beam_step(
            tflat.reshape(B, nb * V), nb, tstate, tseqs, s, eos, do_sample,
            length_penalty=lp, done=tdone, gumbel=torch.tensor(g))
        jdone = jdone | jax_beam.batch_done(jstate, jnp.int32(s), jbest, lp)
        tdone = tdone | beam.batch_done(tstate, s, tbest, lp)
        for got, ref in ((tpar, jpar), (ttok, jtok), (tseqs, jseqs), (tdone, jdone),
                         (tstate.fin_seqs, jstate.fin_seqs), (tstate.fin_lens, jstate.fin_lens)):
            np.testing.assert_array_equal(_np(got), np.asarray(ref))
        for got, ref in ((tstate.scores, jstate.scores), (tstate.fin_scores, jstate.fin_scores),
                         (tbest, jbest)):
            np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-6)
        if bool(jnp.all(jdone)):
            break
    jout = jax_beam.finalize(jstate, jseqs, jnp.int32(s + 1), length_penalty=lp, done=jdone)
    tout = beam.finalize(tstate, tseqs, s + 1, length_penalty=lp, done=tdone)
    for got, ref in zip(tout, jout):
        np.testing.assert_array_equal(_np(got), np.asarray(ref))
    return _np(tdone)


@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("lp", [0.0, 1.1, -0.5])
def test_beam_step_done_and_finalize_match_jax(lp, do_sample):
    _beam_stream(lp, do_sample)


@pytest.mark.parametrize("lp", [-2.0, -20.0])
def test_length_penalty_sentinels(lp):
    """tests/test_beam.py's sentinel cases: a negative length_penalty
    magnifies a banked score below -1e9 (lp=-2), or past the fp32 range
    (lp=-20, clamped to the finite minimum); the bank must still win over
    the -inf empty slots, and a partly filled bank is not full."""
    B, nb, V, L = 1, 3, 8, 8
    eos = V - 1
    state = beam.init_beam_state(B, nb, L)
    seqs = torch.zeros(B, nb, L, dtype=torch.int32)
    done = torch.zeros(B, dtype=torch.bool)
    flat = torch.full((B, nb * V), -5000.0)
    flat[0, eos] = -4000.0                       # rank-0 stop candidate: banked
    state, _, _, seqs, best = beam.beam_step(flat, nb, state, seqs, 599, eos, False,
                                             length_penalty=lp, done=done)
    banked = _np(state.fin_scores[0])
    if lp == -2.0:
        assert np.isclose(banked.max(), -4000.0 * 600.0 ** 2, rtol=1e-6)
        assert not bool(beam.batch_done(state, 599, best, lp)[0])
    else:
        assert np.isfinite(banked.max()) and banked.max() == np.finfo(np.float32).min
    seq, length, from_bank = beam.finalize(state, seqs, 600, length_penalty=lp, done=done)
    assert bool(from_bank[0]) and int(length[0]) > 0


def test_plain_permute_matches_tpu_kernel_interpret():
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 3, 4, 64, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4, 64, 16)).astype(np.float32)
    rows = np.asarray([2, 0, 0], np.int32)               # not a bijection
    rk, rv = jax_permute.permute_cache_rows(jnp.asarray(k), jnp.asarray(v), jnp.asarray(rows),
                                            interpret=True)
    out_k, out_v = torch.empty(k.shape), torch.empty(v.shape)
    gk, gv = permute.permute_cache_rows(torch.tensor(k), torch.tensor(v), torch.tensor(rows),
                                        out_k, out_v)
    assert gk is out_k and gv is out_v and permute.permute_cache_rows.launches == 0
    np.testing.assert_array_equal(_np(gk), np.asarray(rk))
    np.testing.assert_array_equal(_np(gv), np.asarray(rv))


def test_decode_step_lineage_matches_jax(setup):
    _, _, jp, tp = setup
    B, nb, L, H, hd, Pc, Sc, step = 2, 3, 2, 4, 16, 24, 16, 5
    rng = np.random.default_rng(7)
    pk, pv = (rng.standard_normal((L, B, H, Pc, hd)).astype(np.float32) for _ in range(2))
    sk, sv = (rng.standard_normal((L, B * nb, H, Sc, hd)).astype(np.float32) for _ in range(2))
    hidden = rng.standard_normal((B * nb, 1, 64)).astype(np.float32)
    pmask = np.ones((B, Pc), bool)
    pmask[1, :6] = False                                  # left padding of row 1
    pmask[:, 20:] = False
    prefix_bias = np.where(pmask, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    anc = rng.integers(0, nb, (B, nb, Sc))
    owns = anc[:, :, None, :] == np.arange(nb)[None, None, :, None]
    valid = np.arange(Sc)[None, None, None, :] < step
    suffix_bias = np.where(owns & valid, 0.0, -1e9).astype(np.float32)
    size = jax_gpt2.GPT2Size(L, 64, H)
    ref, rsuf = jax_gpt2.decode_step_lineage(
        jp["gpt"], jnp.asarray(hidden), jax_gpt2.KVCache(jnp.asarray(pk), jnp.asarray(pv)),
        jnp.asarray(prefix_bias), jax_gpt2.KVCache(jnp.asarray(sk), jnp.asarray(sv)),
        jnp.asarray(suffix_bias), jnp.int32(step), size, nb)
    suffix = gpt2.KVCache(torch.tensor(sk), torch.tensor(sv))
    got, gsuf = gpt2.decode_step_lineage(
        tp["gpt"], torch.tensor(hidden), gpt2.KVCache(torch.tensor(pk), torch.tensor(pv)),
        torch.tensor(prefix_bias), suffix, torch.tensor(suffix_bias), step,
        gpt2.GPT2Size(L, 64, H), nb)
    assert gsuf.k is suffix.k                             # written in place
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gsuf.k), np.asarray(rsuf.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(_np(gsuf.v), np.asarray(rsuf.v), atol=TOL, rtol=0)


def _prompt(batch_lens, seed):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((1, 32, 64)).astype(np.float32)
    prep = uv.prepare_text_prompt([rng.integers(2, 40, (n,)) for n in batch_lens], 0, 1)
    tokens = np.pad(prep.text_tokens, ((0, 0), (3, 0)))      # left pad: mask holes
    mask = np.pad(prep.attn_text, ((0, 0), (3, 0)))
    return cond, tokens, mask


def _both_beam(setup, batch_lens, seed, kv=(None, None), gumbel=False, **kw):
    jcfg, tcfg, jp, tp = setup
    cond, tokens, mask = _prompt(batch_lens, seed)
    key = jax.random.PRNGKey(seed)
    ref = jax_uv.inference_speech_beam(jp, jcfg, jnp.asarray(cond), jnp.asarray(tokens),
                                       jnp.asarray(mask), key, cache_dtype=jnp.float32,
                                       kv_dtype=kv[0], **kw)
    draws = None
    if gumbel:   # JAX's own per-step noise: fold_in(fold_in(key, 0xBEA3), step)
        bkey = jax.random.fold_in(key, 0xBEA3)
        shape = (len(batch_lens), kw["num_beams"] * jcfg.number_mel_codes)
        draws = [torch.tensor(np.asarray(jax.random.gumbel(jax.random.fold_in(bkey, s), shape)))
                 for s in range(kw["max_new"])]
    got = uv.inference_speech_beam(tp, tcfg, torch.tensor(cond), torch.tensor(tokens).long(),
                                   torch.tensor(mask), None, cache_dtype=torch.float32,
                                   kv_dtype=kv[1], gumbel=draws, **kw)
    np.testing.assert_array_equal(_np(got.codes), np.asarray(ref.codes))
    np.testing.assert_array_equal(_np(got.lengths), np.asarray(ref.lengths))
    np.testing.assert_array_equal(_np(got.finished), np.asarray(ref.finished))
    return got


GREEDY = dict(max_new=16, do_sample=False, repetition_penalty=1.5)


@pytest.mark.parametrize("reorder", ["lineage", "pallas", "full"])
@pytest.mark.parametrize("batch_lens,nb", [((6,), 3), ((7, 4), 2)])
def test_greedy_beam_codes_match_jax(setup, reorder, batch_lens, nb):
    before = permute.permute_cache_rows.launches
    got = _both_beam(setup, batch_lens, 11, reorder=reorder, num_beams=nb, **GREEDY)
    assert got.steps >= 1 and permute.permute_cache_rows.launches == before


@pytest.mark.parametrize("seed", [15, 16])     # a stop at code 11; no stop in 16
def test_beam_sample_codes_match_jax_with_its_gumbel_draws(setup, seed):
    got = _both_beam(setup, (6,), seed, gumbel=True, num_beams=3, max_new=16,
                     do_sample=True, top_k=10, top_p=0.9, repetition_penalty=2.0,
                     temperature=0.9)
    assert int(got.lengths[0]) > 8


def test_greedy_beam_fp8_cache_matches_jax(setup):
    _both_beam(setup, (6,), 13, kv=(jnp.float8_e4m3fn, torch.float8_e4m3fn), num_beams=3,
               **GREEDY)


def test_unknown_reorder_raises(setup):
    _, tcfg, _, tp = setup
    cond, tokens, mask = _prompt((5,), 0)
    with pytest.raises(ValueError, match="reorder"):
        uv.inference_speech_beam(tp, tcfg, torch.tensor(cond), torch.tensor(tokens).long(),
                                 torch.tensor(mask), reorder="gather")
