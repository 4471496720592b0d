"""PyTorch port, pool step: the plain version of the pool-step kernel (K4)
against the TPU kernel in interpret mode and against the JAX flat decode
step, with plain, int8 and fp8-cache tiers; the head-split pool step; and
per-row sampling with JAX's own Gumbel draws.  Weights and inputs come from
numpy seeds; fp32 on both sides (tolerance 2e-4, as tests/test_pool_trunk.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import gpt2 as jax_gpt2
from indextts_tpu.ops import quantization as jax_quant
from indextts_tpu.ops import sampling as jax_sampling
from indextts_tpu.ops.pallas import pool_trunk as jax_pool_trunk
from indextts_tpu_torch.models import gpt2
from indextts_tpu_torch.ops import sampling
from indextts_tpu_torch.ops.cuda import pool_trunk
from tests.test_torch_gpt import gpt_numpy_params

# head width 64, as the kernel's; lane-aligned width, as the TPU kernel's
POOL = dict(model_dim=128, layers=2, heads=2, max_mel_tokens=48, max_text_tokens=30,
            number_text_tokens=40, number_mel_codes=50, start_mel_token=46,
            stop_mel_token=47)
TOL = 2e-4


@pytest.fixture(scope="module")
def trunk():
    """The trunk parameters as numpy, JAX and torch trees."""
    np_params = gpt_numpy_params(jax_config.GPTConfig.from_dict(POOL))["gpt"]
    return (np_params, jax.tree.map(jnp.asarray, np_params),
            jax.tree.map(torch.from_numpy, np_params))


def _inputs(S, T, seed=0):
    """hidden [S, D], cache [L, S, T, D], positions in [T/2, T-1] and masks
    with left-pad holes, zero past each position."""
    rng = np.random.default_rng(seed)
    L, D = POOL["layers"], POOL["model_dim"]
    hidden = rng.standard_normal((S, D)).astype(np.float32)
    k = rng.standard_normal((L, S, T, D)).astype(np.float32)
    v = rng.standard_normal((L, S, T, D)).astype(np.float32)
    pos = rng.integers(T // 2, T - 1, (S,)).astype(np.int32)
    mask = np.zeros((S, T), np.int32)
    for s in range(S):
        mask[s, : pos[s] + 1] = 1
        mask[s, 2: 2 + rng.integers(0, 6)] = 0
    return hidden, k, v, pos, mask


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _size():
    return jax_gpt2.GPT2Size(POOL["layers"], POOL["model_dim"], POOL["heads"])


def _xla_step(jp, hidden, k, v, pos, mask):
    """JAX's flat step: (ln_f output [S, D], cache k, cache v) as numpy."""
    out, kn, vn = jax_gpt2.decode_step_rows_flat(
        jp, jnp.asarray(hidden)[:, None], jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(mask), _size())
    return np.asarray(out)[:, 0], np.asarray(kn), np.asarray(vn)


def _port_step(tp, hidden, k, v, pos, mask, k_dtype=None):
    """The wrapper (plain version on the CPU), ln_f applied and its rows
    scattered into a copy of the cache: (out, k', v') as numpy."""
    kt, vt = _torch(k, v)
    if k_dtype is not None:
        kt, vt = kt.to(k_dtype), vt.to(k_dtype)
    ht, pt, mt = _torch(hidden, pos, mask)
    x, kr, vr = pool_trunk.fused_pool_step(tp, ht, kt, vt, pt, mt, POOL["heads"])
    out = gpt2.layer_norm(x, tp["ln_f"]["scale"], tp["ln_f"]["bias"])
    rows = torch.arange(hidden.shape[0])
    kt[:, rows, pt.long()] = kr
    vt[:, rows, pt.long()] = vr
    return out.numpy(), kt.float().numpy(), vt.float().numpy(), x, kr, vr


def test_plain_matches_the_tpu_kernel_in_interpret_mode(trunk):
    _, jp, tp = trunk
    hidden, k, v, pos, mask = _inputs(8, 40)
    jx, jk, jv = jax_pool_trunk.fused_pool_step(
        jp, jnp.asarray(hidden), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(mask), POOL["heads"], interpret=True)
    *_, x, kr, vr = _port_step(tp, hidden, k, v, pos, mask)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(kr.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(vr.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S,T", [(4, 48), (16, 264)])
def test_plain_matches_the_xla_step(trunk, S, T):
    """Sub-tile and multi-chunk pools: the ln_f output and the cache with the
    new rows scattered equal JAX's flat step, and so do the port's own flat
    step's."""
    _, jp, tp = trunk
    inputs = _inputs(S, T, seed=S)
    want = _xla_step(jp, *inputs)
    got = _port_step(tp, *inputs)[:3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    hidden, k, v, pos, mask = _torch(*(a.copy() for a in inputs))
    flat = gpt2.decode_step_rows_flat(tp, hidden[:, None], k, v, pos, mask,
                                      gpt2.GPT2Size(POOL["layers"], POOL["model_dim"],
                                                    POOL["heads"]))
    for g, w in zip((flat[0][:, 0], flat[1], flat[2]), want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)


def test_plain_int8_matches_the_xla_step(trunk):
    np_params, _, _ = trunk
    jq = jax_quant.quantize_gpt_params({"gpt": jax.tree.map(jnp.asarray, np_params)}, bits=8,
                                       dtype=jnp.float32)["gpt"]
    tq = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jq)
    assert set(tq["blocks"]["attn"]["qkv_w"]) == {"q", "s"}
    inputs = _inputs(8, 40, seed=1)
    want = _xla_step(jq, *inputs)
    got = _port_step(tq, *inputs)[:3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_plain_fp8_cache_follows_the_kernel_on_the_current_slot(trunk):
    """e4m3 cache.  The TPU kernel and its plain version read the current
    token's K/V in the compute type; JAX's flat step writes it to the fp8
    cache first and reads it back.  So: with the current slot masked out the
    two agree, and the new rows agree in e4m3."""
    _, jp, tp = trunk
    hidden, k, v, pos, mask = _inputs(8, 40, seed=2)
    fp8 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float8_e4m3fn))  # noqa: E731
    jk8, jv8 = fp8(k), fp8(v)
    masked = mask.copy()
    masked[np.arange(8), pos] = 0
    want_out, want_k, want_v = _xla_step(jp, hidden, jk8, jv8, pos, masked)
    got_out, got_k, got_v, *_ = _port_step(tp, hidden, k, v, pos, masked,
                                          k_dtype=torch.float8_e4m3fn)
    np.testing.assert_allclose(got_out, want_out, rtol=TOL, atol=TOL)
    # the new rows: the same fp32 values cast to e4m3 (one ulp apart at most)
    np.testing.assert_allclose(got_k, want_k.astype(np.float32), rtol=0.07, atol=2e-3)
    np.testing.assert_allclose(got_v, want_v.astype(np.float32), rtol=0.07, atol=2e-3)
    # with the current slot attended, the compute-type merge moves the output
    got_live = _port_step(tp, hidden, k, v, pos, mask, k_dtype=torch.float8_e4m3fn)[0]
    want_live = _xla_step(jp, hidden, jk8, jv8, pos, mask)[0]
    assert np.all(np.isfinite(got_live))
    assert np.abs(got_live - want_live).max() < 0.1


def test_all_masked_row_is_finite(trunk):
    """A slot that never held a request: mask all zero, position 0.  Its
    output is never used (the pool samples the stop token for it), and each
    implementation averages other slots (XLA all T, the kernels [0, pos]), so
    only finiteness is held; the other rows still equal JAX's."""
    _, jp, tp = trunk
    hidden, k, v, pos, mask = _inputs(4, 48, seed=3)
    pos[1], mask[1] = 0, 0
    got = _port_step(tp, hidden, k, v, pos, mask)
    want = _xla_step(jp, hidden, k, v, pos, mask)
    assert all(np.all(np.isfinite(g)) for g in got[:3])
    others = [0, 2, 3]
    np.testing.assert_allclose(got[0][others], want[0][others], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1][:, others], want[1][:, others], rtol=TOL, atol=TOL)


def test_wrapper_raises_for_shared_int4_and_other_devices(trunk):
    _, _, tp = trunk
    hidden, k, v, pos, mask = _torch(*_inputs(4, 48))
    w = tp["blocks"]["attn"]["qkv_w"]
    int4 = {**tp, "blocks": {**tp["blocks"], "attn": {
        **tp["blocks"]["attn"], "qkv_w": {"q4s": w[:, ::2].to(torch.int8), "s": w[:, :1]}}}}
    with pytest.raises(ValueError, match="q4s"):
        pool_trunk.fused_pool_step(int4, hidden, k, v, pos, mask, POOL["heads"])
    with pytest.raises(ValueError, match="device"):
        pool_trunk.fused_pool_step(tp, hidden.to("meta"), k.to("meta"), v.to("meta"),
                                   pos.to("meta"), mask.to("meta"), POOL["heads"])
    assert pool_trunk.supported(8, 768, 1280, 20, tp)
    assert not pool_trunk.supported(8, 764, 1280, 20, tp)       # T not a multiple of 8
    assert not pool_trunk.supported(12, 768, 1280, 20, tp)      # not whole 8-slot tiles
    assert not pool_trunk.supported(8, 768, 1280, 20, int4)


def test_decode_step_rows_matches_jax(trunk):
    """The default (head-split) pool step: ln_f output and the cache."""
    _, jp, tp = trunk
    hidden, k, v, pos, mask = _inputs(4, 48, seed=4)
    L, S, T, D = k.shape
    H, hd = POOL["heads"], D // POOL["heads"]
    split = lambda a: a.reshape(L, S, T, H, hd).transpose(0, 1, 3, 2, 4)  # noqa: E731
    jcache = jax_gpt2.KVCache(jnp.asarray(split(k)), jnp.asarray(split(v)))
    jout, jc = jax_gpt2.decode_step_rows(jp, jnp.asarray(hidden)[:, None], jcache,
                                         jnp.asarray(pos), jnp.asarray(mask), _size())
    kt, vt = _torch(split(k), split(v))
    out, cache = gpt2.decode_step_rows(tp, torch.from_numpy(hidden)[:, None],
                                       gpt2.KVCache(kt, vt), torch.from_numpy(pos),
                                       torch.from_numpy(mask), gpt2.GPT2Size(L, D, H))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k), rtol=TOL, atol=TOL)
    fk, fv = gpt2.flatten_rows_cache(cache)
    np.testing.assert_allclose(fv.numpy(), np.asarray(jax_gpt2.flatten_rows_cache(jc)[1]),
                               rtol=TOL, atol=TOL)


SAMP = [(0.7, 8, 0.9, 4.0, 1.0), (1.3, 20, 0.6, 1.0, 1.0), (1.0, 30, 1.0, 10.0, 0.0),
        (2.0, 1, 0.8, 1.5, 1.0)]


@pytest.mark.parametrize("shortlist_k", [64, 12])
def test_sample_step_rows_matches_jax_with_its_gumbel_draws(shortlist_k):
    """Per-row parameters (sampled and greedy rows), JAX's noise for keys
    fold_in(PRNGKey(seed), counter): equal tokens and presence."""
    rng = np.random.default_rng(5)
    B, V = len(SAMP), 50
    logits = (3 * rng.standard_normal((B, V))).astype(np.float32)
    presence = rng.random((B, V)) < 0.2
    finished = np.array([False, False, False, True])
    samp = sampling.pack_sampling(*np.asarray(SAMP, np.float32).T)
    seeds, counters = np.array([41, 99, 7, 3], np.int32), np.array([0, 5, 2, 9], np.int32)
    keys = jax_sampling.row_keys(jnp.asarray(seeds), jnp.asarray(counters))
    k = min(shortlist_k, V)
    gumbel = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (k,)))(keys))
    jtok, jpres, jfin = jax_sampling.sample_step_rows(
        keys, jnp.asarray(logits), jnp.asarray(presence), jnp.asarray(finished),
        jnp.asarray(samp), stop_token=47, shortlist_k=shortlist_k)
    ttok, tpres, tfin = sampling.sample_step_rows(
        torch.from_numpy(logits), torch.from_numpy(presence), torch.from_numpy(finished),
        torch.from_numpy(samp), stop_token=47, shortlist_k=shortlist_k,
        gumbel=torch.tensor(gumbel))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpres.numpy(), np.asarray(jpres))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))


def test_greedy_rows_break_ties_to_the_lower_index():
    logits = np.zeros((2, 50), np.float32)
    logits[0, [7, 3, 30]] = 2.0          # a three-way tie: 3 wins
    logits[1, [45, 12]] = 1.0
    samp = sampling.pack_sampling(*np.asarray([(1.0, 30, 0.8, 1.0, 0.0)] * 2, np.float32).T)
    keys = jax_sampling.row_keys(jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    jtok, _, _ = jax_sampling.sample_step_rows(
        keys, jnp.asarray(logits), jnp.zeros((2, 50), bool), jnp.zeros(2, bool),
        jnp.asarray(samp), stop_token=47)
    ttok, _, _ = sampling.sample_step_rows(
        torch.from_numpy(logits), torch.zeros(2, 50, dtype=torch.bool),
        torch.zeros(2, dtype=torch.bool), torch.from_numpy(samp), torch.zeros(2),
        torch.zeros(2), stop_token=47)
    assert ttok.tolist() == np.asarray(jtok).tolist() == [3, 12]


def test_row_gumbel_is_a_function_of_seed_counter_and_column():
    """A row's draws do not depend on the batch it is drawn in, and they are
    standard Gumbel (mean: the Euler-Mascheroni constant)."""
    seeds, counters = torch.tensor([5, 17, 5, 2 ** 31 - 1]), torch.tensor([0, 3, 1, 600])
    g = sampling.row_gumbel(seeds, counters, 64)
    for i in range(4):
        assert torch.equal(sampling.row_gumbel(seeds[i: i + 1], counters[i: i + 1], 64)[0], g[i])
    assert not torch.equal(g[0], g[2])                                   # another counter
    assert torch.equal(sampling.row_gumbel(seeds, counters, 8), g[:, :8])  # columns prefix
    big = sampling.row_gumbel(torch.arange(512), torch.zeros(512, dtype=torch.int64), 64)
    assert abs(big.mean().item() - 0.5772) < 0.02
    assert abs(big.std().item() - 1.2825) < 0.03
