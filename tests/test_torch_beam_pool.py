"""PyTorch port, the continuous beam pool (serve/beam_pool.py): the lineage
step with a write position per row against JAX's, greedy pool codes equal to
JAX's `BeamPoolBatcher` and to the port's dedicated beam decode, sampled
pool codes equal to the dedicated decode fed the pool's draws (group
turnover, staggered admission), cancellation and the fixed knobs, a budget
of one, length penalties and a frozen group's suffix.  Tiny model, weights
from a numpy seed, fp32 on both sides (the cases of tests/test_beam_pool.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import gpt2 as jax_gpt2
from indextts_tpu.serve import beam_pool as jax_beam_pool
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import gpt2, unified_voice as uv
from indextts_tpu_torch.serve.beam_pool import BeamPoolBatcher, select_noise
from tests.test_torch_gpt import TINY, gpt_numpy_params

TOL = 1e-5
NB = 3


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    tcfg = GPTConfig.from_dict(TINY)
    np_params = gpt_numpy_params(jcfg, seed=5)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((1, 32, TINY["model_dim"])).astype(np.float32)
    texts = [rng.integers(2, 40, (n,)) for n in (9, 4, 6, 11, 7, 5)]
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, np_params),
            from_jax.gpt_params_from_numpy(np_params, tcfg), cond, texts)


def _dedicated(setup, text, max_new, seed=0, do_sample=True, temperature=1.0, top_p=0.8,
               repetition_penalty=10.0, length_penalty=0.0, top_k=30):
    """The port's dedicated beam-3 decode of one text (left-padded to 16, as
    the engine pads it), fed the pool's draws for `seed` when sampling."""
    _, tcfg, _, tp, cond, _ = setup
    prep = uv.prepare_text_prompt([text], tcfg.start_text_token, tcfg.stop_text_token)
    pad = -(-prep.text_tokens.shape[1] // 16) * 16 - prep.text_tokens.shape[1]
    tokens = torch.as_tensor(np.pad(prep.text_tokens, ((0, 0), (pad, 0))))
    mask = torch.as_tensor(np.pad(prep.attn_text, ((0, 0), (pad, 0))))
    draws = None
    if do_sample:
        seeds = torch.tensor([seed])
        draws = [select_noise(seeds, torch.tensor([i]), NB * tcfg.number_mel_codes)
                 for i in range(max_new)]
    r = uv.inference_speech_beam(tp, tcfg, torch.as_tensor(cond), tokens, mask, None,
                                 max_new=max_new, num_beams=NB, temperature=temperature,
                                 top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty,
                                 do_sample=do_sample, length_penalty=length_penalty,
                                 cache_dtype=torch.float32, gumbel=draws)
    return r.codes[0, : int(r.lengths[0])].numpy()


def _pool(setup, **kw):
    _, tcfg, _, tp, cond, _ = setup
    args = dict(num_groups=2, num_beams=NB, max_text_width=16, max_new=16,
                cache_dtype=torch.float32)
    args.update(kw)
    return BeamPoolBatcher(tp, tcfg, torch.as_tensor(cond), **args)


def test_decode_step_lineage_rows_matches_jax(setup):
    """Two groups at their own positions, group 1 parked at Sc: hidden
    states and the suffix within 1e-5 of JAX's, and the parked rows' suffix
    exactly as it was."""
    _, _, jp, tp, _, _ = setup
    B, L, H, hd, Pc, Sc = 2, 2, 4, 16, 24, 16
    rng = np.random.default_rng(7)
    pk, pv = (rng.standard_normal((L, B, H, Pc, hd)).astype(np.float32) for _ in range(2))
    sk, sv = (rng.standard_normal((L, B * NB, H, Sc, hd)).astype(np.float32) for _ in range(2))
    hidden = rng.standard_normal((B * NB, 1, 64)).astype(np.float32)
    pmask = np.ones((B, Pc), bool)
    pmask[1, :6] = False
    pmask[:, 20:] = False
    prefix_bias = np.where(pmask, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    steps = np.asarray([5, 9])
    anc = rng.integers(0, NB, (B, NB, Sc))
    owns = anc[:, :, None, :] == np.arange(NB)[None, None, :, None]
    valid = np.arange(Sc)[None, None, None, :] < steps[:, None, None, None]
    suffix_bias = np.where(owns & valid, 0.0, -1e9).astype(np.float32)
    positions = np.repeat(np.asarray([steps[0] - 1, Sc]), NB).astype(np.int32)
    ref, rsuf = jax_gpt2.decode_step_lineage_rows(
        jp["gpt"], jnp.asarray(hidden), jax_gpt2.KVCache(jnp.asarray(pk), jnp.asarray(pv)),
        jnp.asarray(prefix_bias), jax_gpt2.KVCache(jnp.asarray(sk), jnp.asarray(sv)),
        jnp.asarray(suffix_bias), jnp.asarray(positions), jax_gpt2.GPT2Size(L, 64, H), NB)
    suffix = gpt2.KVCache(torch.tensor(sk), torch.tensor(sv))
    got, gsuf = gpt2.decode_step_lineage_rows(
        tp["gpt"], torch.tensor(hidden), gpt2.KVCache(torch.tensor(pk), torch.tensor(pv)),
        torch.tensor(prefix_bias), suffix, torch.tensor(suffix_bias),
        torch.tensor(positions), gpt2.GPT2Size(L, 64, H), NB)
    assert gsuf.k is suffix.k                             # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    np.testing.assert_allclose(gsuf.k.numpy(), np.asarray(rsuf.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(gsuf.v.numpy(), np.asarray(rsuf.v), atol=TOL, rtol=0)
    np.testing.assert_array_equal(gsuf.k[:, NB:].numpy(), sk[:, NB:])
    np.testing.assert_array_equal(gsuf.v[:, NB:].numpy(), sv[:, NB:])
    assert not np.array_equal(gsuf.k[:, :NB, :, steps[0] - 1].numpy(), sk[:, :NB, :, steps[0] - 1])


GREEDY_CASES = {"lp 0, budget 16": dict(max_new=16, length_penalty=0.0),
                "lp 1, budget 10": dict(max_new=10, length_penalty=1.0),
                "lp -2, budget 16": dict(max_new=16, length_penalty=-2.0)}


@pytest.mark.parametrize("steps_per_tick", [1, 3])
def test_greedy_pool_codes_equal_the_jax_pool_and_dedicated_decode(setup, steps_per_tick):
    """do_sample=False beam search with per-request length penalties and
    budgets, three requests through two groups: the port's pool, JAX's pool
    and the port's dedicated decode give the same codes."""
    jcfg, _, jp, _, cond, texts = setup
    cases = list(GREEDY_CASES.values())
    common = dict(num_groups=2, num_beams=NB, max_text_width=16, max_new=16, do_sample=False)
    jpool = jax_beam_pool.BeamPoolBatcher(jp, jcfg, jnp.asarray(cond), cache_dtype=jnp.float32,
                                          **common)
    tpool = _pool(setup, do_sample=False, steps_per_tick=steps_per_tick)
    ids = {}
    for name, pool in (("jax", jpool), ("port", tpool)):
        ids[name] = [pool.submit(t, max_new=c["max_new"], seed=5,
                                 sampling={"length_penalty": c["length_penalty"]})
                     for t, c in zip(texts, cases)]
    jres, tres = jpool.run(), tpool.run()
    for (jid, tid), t, c in zip(zip(ids["jax"], ids["port"]), texts, cases):
        want = _dedicated(setup, t, c["max_new"], do_sample=False,
                          length_penalty=c["length_penalty"])
        np.testing.assert_array_equal(np.asarray(jres[jid]), want)
        np.testing.assert_array_equal(tres[tid], want)


def test_sampled_pool_codes_equal_dedicated_decode_with_the_same_draws(setup):
    """Four beam-sample requests with their own seeds and knobs through two
    groups (group turnover), two steps a tick: each equals the dedicated
    decode fed the same draws."""
    texts = setup[5][:4]
    kws = [dict(seed=11, temperature=0.9, top_p=0.85, repetition_penalty=4.0),
           dict(seed=22, temperature=1.3, top_p=0.7, repetition_penalty=1.5),
           dict(seed=33, temperature=1.0, top_p=0.8, repetition_penalty=10.0),
           dict(seed=44, temperature=0.7, top_p=0.95, repetition_penalty=2.0)]
    pool = _pool(setup, steps_per_tick=2)
    ids = [pool.submit(t, max_new=16, seed=kw["seed"],
                       sampling={k: v for k, v in kw.items() if k != "seed"})
           for t, kw in zip(texts, kws)]
    res = pool.run()
    assert set(res) == set(ids)
    lens = []
    for rid, t, kw in zip(ids, texts, kws):
        np.testing.assert_array_equal(res[rid], _dedicated(setup, t, 16, **kw),
                                      err_msg=f"request {rid}")
        lens.append(len(res[rid]))
    assert max(lens) > 4


def test_staggered_admission(setup):
    """A request admitted while another group is several steps in gives the
    codes it gives alone; the first request's codes do not change."""
    texts = setup[5]
    pool = _pool(setup)
    out = {}
    cb = lambda rid, codes: out.__setitem__(rid, codes)  # noqa: E731
    r1 = pool.submit(texts[0], max_new=14, seed=7, done_cb=cb)
    for _ in range(4):
        pool.step()
    r2 = pool.submit(texts[1], max_new=14, seed=8, done_cb=cb)
    while pool._queue or pool._live:
        pool.step()
    pool.flush()
    np.testing.assert_array_equal(out[r1], _dedicated(setup, texts[0], 14, seed=7))
    np.testing.assert_array_equal(out[r2], _dedicated(setup, texts[1], 14, seed=8))


def test_frozen_group_suffix_stays_as_it_was(setup):
    """A group that finished (budget 3) is frozen while another decodes: its
    suffix rows do not change, as JAX's drop-mode scatter leaves them."""
    texts = setup[5]
    pool = _pool(setup)
    r1 = pool.submit(texts[2], max_new=3, seed=1)
    pool.submit(texts[3], max_new=16, seed=2)
    pool.step()
    pool.step()
    pool.step()
    assert not bool(pool.state.active[0]) and bool(pool.state.active[1])
    before = [t[:, :NB].clone() for t in pool.state.suffix]
    for _ in range(3):
        pool.step()
    for b, t in zip(before, pool.state.suffix):
        assert torch.equal(b, t[:, :NB])
    res = pool.run()
    assert r1 not in res          # finished in an earlier report, callback-free


def test_cancel_and_static_knob_validation(setup):
    texts = setup[5]
    pool = _pool(setup, num_groups=1)
    for knob, value in (("top_k", 7), ("num_beams", 2), ("do_sample", False)):
        with pytest.raises(ValueError, match=knob):
            pool.submit(texts[0], sampling={knob: value})
    with pytest.raises(ValueError, match="max_text_width"):
        pool.submit(np.ones(17, np.int32))
    res = {}
    r1 = pool.submit(texts[4], max_new=16, seed=3, done_cb=res.__setitem__)
    r2 = pool.submit(texts[5], max_new=16, seed=4, done_cb=res.__setitem__)   # queued
    pool.step()
    pool.cancel(r1)               # the only group's request: the queued one follows
    for _ in range(100):          # bounded: a stalled pool fails, not hangs
        if not (pool._queue or pool._live):
            break
        pool.step()
    pool.flush()
    assert r1 not in res
    np.testing.assert_array_equal(res[r2], _dedicated(setup, texts[5], 16, seed=4))


def test_budget_of_one(setup):
    """budget 1: the admission select made the only token; the group
    finalizes without a trunk step."""
    text = setup[5][1]
    pool = _pool(setup, num_groups=1, max_new=8)
    rid = pool.submit(text, max_new=1, seed=9)
    res = pool.run()
    np.testing.assert_array_equal(res[rid], _dedicated(setup, text, 1, seed=9))
    assert len(res[rid]) == 1


@pytest.mark.parametrize("lp", [1.0, -2.0])
def test_sampled_length_penalty(setup, lp):
    """A non-zero length penalty on the sampled path, per request."""
    text = setup[5][3]
    pool = _pool(setup, num_groups=1)
    rid = pool.submit(text, max_new=16, seed=21, sampling={"length_penalty": lp})
    res = pool.run()
    np.testing.assert_array_equal(res[rid], _dedicated(setup, text, 16, seed=21,
                                                       length_penalty=lp))
