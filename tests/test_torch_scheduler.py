"""PyTorch port, continuous-batching pool (serve/scheduler.py): greedy codes
equal to the JAX pool's and to single-request decode in every mode
(single-step ticks, multi-step ticks with staged refill, the pool-step
kernel's plain version), cancellation, a failing callback, a PoolGroup of
two CPU pools, per-request seeds and sampling validation.  Tiny model with a
head width of 64, weights from a numpy seed, fp32 on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.serve import scheduler as jax_scheduler
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.serve.scheduler import ContinuousBatcher, PoolGroup
from tests.test_torch_gpt import gpt_numpy_params
from tests.test_torch_pool_trunk import POOL

MAX_NEW = 12
GREEDY = dict(do_sample=False, repetition_penalty=1.0, max_text_width=16, max_new=MAX_NEW)


@pytest.fixture(scope="module")
def setup():
    """JAX and port parameters and conditioning, six prompts, and the JAX
    reference codes of each: its pool (single-step ticks) and its
    single-request decode."""
    jcfg = jax_config.GPTConfig.from_dict(POOL)
    tcfg = GPTConfig.from_dict(POOL)
    np_params = gpt_numpy_params(jcfg, seed=3)
    # requests 0 and 3 stop at their first token, the others run to budget
    np_params["mel_head"]["bias"][POOL["stop_mel_token"]] -= 0.25
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = from_jax.gpt_params_from_numpy(np_params, tcfg)
    rng = np.random.default_rng(0)
    cond = rng.standard_normal((1, 32, POOL["model_dim"])).astype(np.float32)
    texts = [rng.integers(2, 40, (n,)) for n in (9, 4, 6, 11, 5, 7)]
    jb = jax_scheduler.ContinuousBatcher(jp, jcfg, jnp.asarray(cond), num_slots=2,
                                         cache_dtype=jnp.float32, **GREEDY)
    ids = [jb.submit(t, max_new=MAX_NEW) for t in texts]
    res = jb.run()
    pool_codes = [res[i] for i in ids]
    single = []
    for t in texts:
        prep = jax_uv.prepare_text_prompt([t], jcfg.start_text_token, jcfg.stop_text_token)
        pad = 16 - prep.text_tokens.shape[1]
        r = jax_uv.inference_speech(
            jp, jcfg, jnp.asarray(cond), jnp.asarray(np.pad(prep.text_tokens, ((0, 0), (pad, 0)))),
            jnp.asarray(np.pad(prep.attn_text, ((0, 0), (pad, 0)))), jax.random.PRNGKey(0),
            max_new=MAX_NEW, do_sample=False, repetition_penalty=1.0, cache_dtype=jnp.float32)
        single.append(np.asarray(r.codes[0, : int(r.lengths[0])]))
    return tcfg, tp, torch.from_numpy(cond), texts, pool_codes, single


def _pool(setup, **kw):
    tcfg, tp, cond = setup[:3]
    args = dict(GREEDY, num_slots=2, cache_dtype=torch.float32)
    args.update(kw)
    return ContinuousBatcher(tp, tcfg, cond, **args)


MODES = {"single-step ticks": dict(),
         "4-step ticks, staged refill": dict(steps_per_tick=4, staging_rows=2),
         "adaptive 4-step ticks": dict(steps_per_tick=4, adaptive_ticks=True),
         "pool-step kernel (plain on the CPU)": dict(steps_per_tick=2, staging_rows=2,
                                                     fused_trunk=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_pool_greedy_codes_equal_the_jax_pool_and_single_decode(setup, mode):
    *_, texts, pool_codes, single = setup
    np.testing.assert_array_equal(np.concatenate(pool_codes), np.concatenate(single))
    b = _pool(setup, **MODES[mode])
    if mode.startswith("pool-step"):
        assert b.fused and b.state.cache.k.ndim == 4 and b.cache_len % 8 == 0
    res, sizes = {}, []
    ids = [b.submit(t, max_new=MAX_NEW, done_cb=res.__setitem__) for t in texts]
    while b._queue or b._live:
        sizes.append(b._tick_steps())
        b.step()
    b.flush()
    if mode.startswith("adaptive"):
        # shorter ticks while requests queue, full ticks once the queue is empty
        assert b.K == 0 and min(sizes) < 4 and max(sizes) == 4, sizes
    assert set(res) == set(ids)
    for rid, want in zip(ids, pool_codes):
        np.testing.assert_array_equal(res[rid], want, err_msg=f"request {rid}")


@pytest.mark.parametrize("staging_rows", [0, 2])
def test_cancelling_every_occupant_frees_the_slots(setup, staging_rows):
    """Every live request cancelled while others queue: the pool still runs
    a tick, whose report frees the slots, so the queued requests are served
    (with none live, the pool would otherwise wait forever on slots its last
    report showed busy)."""
    *_, texts, pool_codes, _ = setup
    order = [1, 2, 4, 5, 0, 3]    # the first four run to their budget
    b = _pool(setup, steps_per_tick=2, staging_rows=staging_rows)
    ids = {b.submit(texts[i], max_new=MAX_NEW): i for i in order}
    b.step()
    live = [r.req_id for r in b._live.values()]
    assert len(live) == 2 + staging_rows and b._queue
    for rid in live:
        b.cancel(rid)
    res = {}
    for req in b._queue:
        req.done_cb = res.__setitem__
    for _ in range(100):          # bounded: a stalled pool fails, not hangs
        if not (b._queue or b._live):
            break
        b.step()
    b.flush()
    assert set(res) == set(ids) - set(live)
    for rid in res:
        np.testing.assert_array_equal(res[rid], pool_codes[ids[rid]])


def test_fused_trunk_refuses_what_the_kernel_does_not_take(setup):
    tcfg, tp, cond = setup[:3]
    with pytest.raises(ValueError, match="fused_trunk"):
        _pool(setup, num_slots=12, fused_trunk=True)             # not whole 8-slot tiles
    from indextts_tpu_torch.ops import quantization
    int4 = quantization.quantize_gpt_params(tp, bits=4, int4_layout="shared")
    with pytest.raises(ValueError, match="fused_trunk"):
        ContinuousBatcher(int4, tcfg, cond, fused_trunk=True, **GREEDY)
    assert not _pool(setup).fused                                 # the reference default


def test_adaptive_ticks_rejects_staging_and_defaults_it_off(setup):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _pool(setup, adaptive_ticks=True, staging_rows=2)
    b = _pool(setup, steps_per_tick=4, adaptive_ticks=True)
    assert b.K == 0 and b.adaptive_ticks


def test_cancel_queued_live_and_staged(setup):
    """A live, a queued and a staged request cancelled: none calls back, the
    others still equal the JAX pool's codes."""
    *_, texts, pool_codes, _ = setup
    b = _pool(setup)
    ids = [b.submit(t, max_new=MAX_NEW) for t in texts[:5]]
    b.step()                      # ids[0], ids[1] in the two slots
    b.cancel(ids[1])              # live
    b.cancel(ids[3])              # queued
    b.cancel(987654)              # unknown: ignored
    res = b.run()
    assert set(res) == {ids[0], ids[2], ids[4]}
    for rid in res:
        np.testing.assert_array_equal(res[rid], pool_codes[ids.index(rid)])

    b = _pool(setup, steps_per_tick=4, staging_rows=2)
    ids = [b.submit(t, max_new=MAX_NEW) for t in texts]
    b.step()                      # 2 admitted, 2 staged, 2 queued
    staged_seq = b._staged_fifo[0][0]
    staged = b._live[staged_seq].req_id
    b.cancel(staged)
    res = b.run()
    assert set(res) == set(ids) - {staged}
    for rid in res:
        np.testing.assert_array_equal(res[rid], pool_codes[ids.index(rid)])
    assert not b._staged_fifo and sorted(b._stage_free_rows) == [0, 1]


def test_failing_done_cb_does_not_stop_the_report(setup):
    *_, texts, _, _ = setup
    b = _pool(setup, steps_per_tick=4, staging_rows=2, max_new=6)
    good = {}

    def boom(rid, codes):
        raise RuntimeError("failing callback")

    ids = [b.submit(t, max_new=6, done_cb=boom if i == 0 else
                    (lambda rid, codes: good.__setitem__(rid, codes)))
           for i, t in enumerate(texts)]
    while b._queue or b._live:
        b.step()
    b.flush()
    assert set(good) == set(ids[1:])
    assert not b._staged_fifo and sorted(b._stage_free_rows) == [0, 1] and not b._live


def test_pool_group_of_two_cpu_pools(setup):
    tcfg, tp, cond, texts, pool_codes, _ = setup
    group = PoolGroup.create(tp, tcfg, cond, ["cpu", "cpu"], num_slots=1,
                             cache_dtype=torch.float32, **GREEDY)
    seen = []
    gids = [group.submit(t, max_new=MAX_NEW) for t in texts[:4]]
    assert gids == [0, 1, 2, 3]
    cb_id = group.submit(texts[4], max_new=MAX_NEW, done_cb=lambda rid, c: seen.append(rid))
    group.cancel(gids[1])
    group.cancel(4242)
    res = group.run()
    assert set(res) == {gids[0], gids[2], gids[3]} and seen == [cb_id]
    for gid in res:
        np.testing.assert_array_equal(res[gid], pool_codes[gid])
    assert all(b._next_seq > 0 for b in group.batchers) and not group._routes


SAMP_A = dict(temperature=0.7, top_k=8, top_p=0.9, repetition_penalty=4.0, do_sample=True)
SAMP_B = dict(temperature=1.3, top_k=20, top_p=0.6, repetition_penalty=1.0, do_sample=True)


def test_per_request_seed_reproducible_under_traffic(setup):
    """(seed, sampling, text) fix a request's codes: alone, behind other
    traffic, and in a staged multi-step pool of another width."""
    *_, texts, _, _ = setup

    def run_pair(num_slots, steps_per_tick, staging_rows, noise):
        b = _pool(setup, num_slots=num_slots, steps_per_tick=steps_per_tick,
                  staging_rows=staging_rows, do_sample=True)
        if noise:
            for t in texts[2:5]:
                b.submit(t, max_new=9, sampling=dict(temperature=2.0, top_k=30), seed=123)
        ids = [b.submit(texts[0], sampling=SAMP_A, seed=41),
               b.submit(texts[1], sampling=SAMP_B, seed=99)]
        res = b.run()
        return [res[i] for i in ids]

    ref = run_pair(2, 1, 0, noise=False)
    assert any(len(r) > 0 for r in ref)
    for args in [(2, 1, 0, True), (3, 4, 2, True), (1, 2, 1, False)]:
        for r, g in zip(ref, run_pair(*args)):
            np.testing.assert_array_equal(r, g, err_msg=f"pool {args}")


def test_per_request_seed_changes_the_codes(setup):
    *_, texts, _, _ = setup
    samp = dict(temperature=1.5, top_k=30, top_p=1.0, repetition_penalty=1.0, do_sample=True)
    b = _pool(setup, max_new=16)
    i1, i2, i3 = (b.submit(texts[3], sampling=samp, seed=s) for s in (1, 2, 1))
    res = b.run()
    np.testing.assert_array_equal(res[i1], res[i3])
    assert len(res[i1]) != len(res[i2]) or not np.array_equal(res[i1], res[i2])


def test_sampling_validation_and_budgets(setup):
    *_, texts, pool_codes, _ = setup
    b = _pool(setup, num_slots=1)
    for bad, match in [(dict(top_k=0), "top_k"), (dict(top_k=65), "top_k"),
                       (dict(temperature=0.0), "temperature"), (dict(top_p=0.0), "top_p"),
                       (dict(repetition_penalty=-1.0), "repetition_penalty")]:
        with pytest.raises(ValueError, match=match):
            b.submit(texts[0], sampling=dict(do_sample=True, **bad))
    with pytest.raises(ValueError, match="max_text_width"):
        b.submit(np.ones(17, np.int32))
    ok = b.submit(texts[0], sampling=dict(do_sample=False, top_k=0, repetition_penalty=1.0))
    zero = b.submit(texts[1], max_new=0)
    one = b.submit(texts[2], max_new=1)
    res = b.run()
    np.testing.assert_array_equal(res[ok], pool_codes[0])
    assert len(res[zero]) == 0 and len(res[one]) <= 1


