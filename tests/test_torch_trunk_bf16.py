"""PyTorch port, the trunk kernels' plain versions at bf16 against the TPU
kernels in interpret mode at bf16, on the same numpy-seeded weights: K2's
plain version (`decode_trunk_plain`) on the bf16, int8, int4 and fp8-cache
tiers, and K4's (`pool_step_plain`) on bf16 and int8 weights.

The two differ in where they round.  The TPU kernels cast each product's
input to bf16 and multiply q and k in bf16 before the head sums; the port's
plain versions (and its CUDA kernels) keep the activations in fp32 and the
products at fp32 accuracy.  Each rounding moves a value by at most half a
bf16 ulp, and at two layers the outputs stay within a few bf16 ulps: the
tolerance is 4 ulps of max|ref| (4 * 2^-7 * max|ref|), the new K/V rows 4
ulps of their own max (an e4m3 cache: that, plus one e4m3 step, 2^-3
relative)."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.ops import quantization as jax_quant
from indextts_tpu.ops.pallas import decode_layer as jax_decode_layer
from indextts_tpu.ops.pallas import pool_trunk as jax_pool_trunk
from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.ops.cuda import decode_layer, pool_trunk
from tests.test_torch_gpt import TINY, gpt_numpy_params
from tests.test_torch_pool_trunk import POOL

ULPS = 4


def _tol(ref) -> float:
    return ULPS * 2.0 ** -7 * float(np.abs(ref).max())


def _bf16_trees(np_trunk, bits):
    """The trunk as a JAX and a torch tree in bf16: quantized (if bits) from
    the same fp32 weights on both sides (their integers and scales are equal,
    tests/test_torch_quant.py), the scales kept fp32, every other leaf cast
    to bf16."""
    jt = jax.tree.map(jnp.asarray, np_trunk)
    tt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), np_trunk)
    if bits:
        jt = jax_quant.quantize_gpt_params({"gpt": jt}, bits=bits, dtype=jnp.float32)["gpt"]
        tt = quant.quantize_gpt_params({"gpt": tt}, bits=bits)["gpt"]

    def cast_j(path, a):
        last = path[-1].key
        return a if last in ("s", "q", "q4") else a.astype(jnp.bfloat16)

    def cast_t(path, t):
        last = path[-1].key
        return t if last in ("s", "q", "q4") else t.to(torch.bfloat16)

    return (jax.tree_util.tree_map_with_path(cast_j, jt),
            jax.tree_util.tree_map_with_path(cast_t, tt))


def _bf16(a):
    """numpy fp32 -> the same values rounded to bf16, as fp32."""
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def k2_trunk():
    return gpt_numpy_params(jax_config.GPTConfig.from_dict(TINY))["gpt"]


@pytest.fixture(scope="module")
def k4_trunk():
    return gpt_numpy_params(jax_config.GPTConfig.from_dict(POOL))["gpt"]


@pytest.mark.parametrize("tier", ["bf16", "int8", "int4", "fp8_cache"])
def test_decode_trunk_plain_bf16_matches_tpu_kernel_interpret(k2_trunk, tier):
    """K2 at TINY (2 layers, width 64, 4 heads), T = 64, position 45 with a
    left-pad hole."""
    T, pos, heads = 64, 45, TINY["heads"]
    jt, tt = _bf16_trees(k2_trunk, {"int8": 8, "int4": 4}.get(tier, 0))
    rng = np.random.default_rng(11)
    D = TINY["model_dim"]
    k = _bf16(2 * rng.standard_normal((2, T, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((2, T, D)).astype(np.float32))
    hidden = _bf16(rng.standard_normal((1, 1, D)).astype(np.float32))
    mask = np.zeros((1, T), np.int32)
    mask[0, : pos + 1] = 1
    mask[0, 3:9] = 0
    cache_j = jnp.float8_e4m3fn if tier == "fp8_cache" else jnp.bfloat16
    cache_t = torch.float8_e4m3fn if tier == "fp8_cache" else torch.bfloat16
    ref, rk, rv = jax_decode_layer.fused_decode_trunk_flat(
        jt, jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(k).astype(cache_j),
        jnp.asarray(v).astype(cache_j), jnp.int32(pos), jnp.asarray(mask), heads=heads,
        interpret=True)
    tk = torch.from_numpy(k).to(cache_t)
    tv = torch.from_numpy(v).to(cache_t)
    got, gk, gv = decode_layer.fused_decode_trunk_flat(
        tt, torch.from_numpy(hidden).to(torch.bfloat16), tk, tv, pos, torch.from_numpy(mask),
        heads)
    assert got.dtype == torch.bfloat16 and gk.dtype == cache_t
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_tol(ref), rtol=0)
    for g_c, r_c in ((gk, rk), (gv, rv)):
        g_row = g_c[:, pos].float().numpy()
        r_row = np.asarray(r_c[:, pos].astype(jnp.float32))
        if tier == "fp8_cache":   # the rows' 4-ulp difference, then one e4m3 step
            np.testing.assert_allclose(g_row, r_row, rtol=2 ** -3, atol=_tol(r_row))
        else:
            np.testing.assert_allclose(g_row, r_row, atol=_tol(r_row), rtol=0)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_pool_step_plain_bf16_matches_tpu_kernel_interpret(k4_trunk, tier):
    """K4 at the pool tests' config (2 layers, width 128, 2 heads), S = 8
    rows at their own positions in T = 40, left-pad holes."""
    S, T, heads = 8, 40, POOL["heads"]
    D, L = POOL["model_dim"], POOL["layers"]
    jt, tt = _bf16_trees(k4_trunk, 8 if tier == "int8" else 0)
    rng = np.random.default_rng(12)
    hidden = _bf16(rng.standard_normal((S, D)).astype(np.float32))
    k = _bf16(rng.standard_normal((L, S, T, D)).astype(np.float32))
    v = _bf16(rng.standard_normal((L, S, T, D)).astype(np.float32))
    pos = rng.integers(T // 2, T - 1, (S,)).astype(np.int32)
    mask = (np.arange(T)[None, :] <= pos[:, None]).astype(np.int32)
    mask[:, 2:5] = 0
    jx, jk, jv = jax_pool_trunk.fused_pool_step(
        jt, jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(mask), heads,
        interpret=True)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    x, kr, vr = pool_trunk.fused_pool_step(tt, bf(hidden), bf(k), bf(v), torch.from_numpy(pos),
                                           torch.from_numpy(mask), heads)
    assert x.dtype == kr.dtype == torch.bfloat16
    for g, r in ((x, jx), (kr, jk), (vr, jv)):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), r, atol=_tol(r), rtol=0)
