"""PyTorch port, weight tiers: the quantized integers and scales against the
JAX package's from the same float tree, the quantized matmul and dequantize
for every weight form, and the decode-trunk kernel's plain version on its
int8, int4 and fp8-cache tiers against the TPU kernel in interpret mode."""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.ops import quantization as jax_quant
from indextts_tpu.ops.pallas import decode_layer as jax_decode_layer
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.ops import quantization as quant
from indextts_tpu_torch.ops.cuda import decode_layer
from tests.test_torch_gpt import TINY, gpt_numpy_params

# fp32 on both sides; integer grids are exact in fp32, so only summation
# order and the order of scaling differ
TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.float8_e4m3fn else x.numpy()
    return np.asarray(x)


def _same_tree(got, ref, path="params"):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _same_tree(got[k], ref[k], f"{path}.{k}")
        return
    g, r = _np(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape, (path, g.dtype, r.dtype)
    np.testing.assert_array_equal(g, r, err_msg=path)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    tcfg = GPTConfig.from_dict(TINY)
    np_params = gpt_numpy_params(jcfg)
    return jcfg, tcfg, np_params


def _matrix(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("form", ["int8", "int4_g1", "int4_g4", "int4_shared"])
def test_quantized_integers_and_scales_equal_jax(form):
    w = _matrix((3, 64, 40), 0)
    if form == "int8":
        ref, got = (jax_quant.quantize_int(jnp.asarray(w), 8, reduce_axes=(1,)),
                    quant.quantize_int(torch.from_numpy(w), 8, reduce_axes=(1,)))
    elif form == "int4_shared":
        ref, got = (jax_quant.quantize_int4_shared(jnp.asarray(w)),
                    quant.quantize_int4_shared(torch.from_numpy(w)))
    else:
        g = 4 if form == "int4_g4" else 1
        ref = jax_quant.quantize_int4_packed(jnp.asarray(w), k_axis=1, groups=g)
        got = quant.quantize_int4_packed(torch.from_numpy(w), k_axis=1, groups=g)
    _same_tree(got, ref)


@pytest.mark.parametrize("bits,layout", [(8, "fused"), (4, "fused"), (4, "shared")])
def test_quantize_gpt_params_equals_jax(setup, bits, layout):
    _, tcfg, np_params = setup
    ref = jax_quant.quantize_gpt_params(jax.tree.map(jnp.asarray, np_params), bits=bits,
                                        int4_layout=layout)
    got = quant.quantize_gpt_params(from_jax.gpt_params_from_numpy(np_params, tcfg),
                                    bits=bits, int4_layout=layout)
    _same_tree(got, ref)
    # the quantized tree carries across from numpy as it is
    carried = from_jax.gpt_params_from_numpy(jax.tree.map(np.asarray, ref), tcfg)
    _same_tree(carried, ref)


def test_from_numpy_rejects_a_wrong_quantized_layout(setup):
    _, tcfg, np_params = setup
    ref = jax.tree.map(np.asarray, jax_quant.quantize_gpt_params(
        jax.tree.map(jnp.asarray, np_params), bits=8))
    ref["gpt"]["blocks"]["attn"]["qkv_w"]["s"] = ref["gpt"]["blocks"]["attn"]["qkv_w"]["s"][
        :, :, :-1]
    with pytest.raises(ValueError, match="qkv_w"):
        from_jax.gpt_params_from_numpy(ref, tcfg)


@pytest.mark.parametrize("form", ["plain", "int8", "int4_g1", "int4_g4", "int4_shared",
                                  "int4_native"])
def test_matmul_quant_and_dequantize_match_jax(form):
    w = _matrix((64, 48), 1)
    x = np.random.default_rng(2).standard_normal((2, 5, 64)).astype(np.float32)
    jw = jnp.asarray(w)
    if form == "plain":
        jq, tq = jw, torch.from_numpy(w)
    elif form == "int8":
        jq, tq = jax_quant.quantize_int(jw), quant.quantize_int(torch.from_numpy(w))
    elif form.startswith("int4_g"):
        g = int(form[-1])
        jq = jax_quant.quantize_int4_packed(jw, groups=g)
        tq = quant.quantize_int4_packed(torch.from_numpy(w), groups=g)
    else:
        jq = jax_quant.quantize_int4_shared(jw)
        tq = quant.quantize_int4_shared(torch.from_numpy(w))
        if form == "int4_native":
            jq, tq = jax_quant.nativize_int4(jq), quant.nativize_int4(tq)
            assert tq["q4n"].dtype == torch.int8 and tuple(tq["q4n"].shape) == (64, 48)
            assert int(tq["q4n"].min()) >= -8 and int(tq["q4n"].max()) <= 7
    ref = jax_quant.matmul_quant(jnp.asarray(x), jq)
    got = quant.matmul_quant(torch.from_numpy(x), tq)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=TOL, rtol=0)
    if form != "plain":
        np.testing.assert_allclose(_np(quant.dequantize(tq, torch.float32)),
                                   np.asarray(jax_quant.dequantize(jq, jnp.float32)),
                                   atol=1e-7, rtol=0)


@pytest.mark.parametrize("tier", ["int8", "int4", "fp8_cache"])
@pytest.mark.parametrize("position,holes", [(37, False), (290, True)])
def test_decode_trunk_plain_tiers_match_tpu_kernel_interpret(setup, tier, position, holes):
    """The kernel's plain version on each tier against the TPU kernel in
    interpret mode, fp32 activations (the TPU kernel's compute type follows
    hidden's).  Quantized weights are exact in fp32 on both sides; an fp8
    cache holds the same e4m3 values on both sides, and the token's own K/V
    enters attention unrounded in both.  Tolerance 1e-5, as for fp32 sums in
    another order; the new fp8 rows within one e4m3 step."""
    _, tcfg, np_params = setup
    T = 512
    rng = np.random.default_rng(position)
    k = (2 * rng.standard_normal((2, T, 64))).astype(np.float32)
    v = rng.standard_normal((2, T, 64)).astype(np.float32)
    hidden = rng.standard_normal((1, 1, 64)).astype(np.float32)
    mask = np.zeros((1, T), np.int32)
    mask[0, : position + 1] = 1
    if holes:
        mask[0, 5:21] = 0
        mask[0, 250:270] = 0
    jgpt = jax.tree.map(jnp.asarray, np_params["gpt"])
    tgpt = from_jax.gpt_params_from_numpy(np_params, tcfg)["gpt"]
    if tier in ("int8", "int4"):
        bits = 8 if tier == "int8" else 4
        jgpt = jax_quant.quantize_gpt_params({"gpt": jgpt}, bits=bits)["gpt"]
        tgpt = quant.quantize_gpt_params({"gpt": tgpt}, bits=bits)["gpt"]
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.tensor(k), torch.tensor(v)
    else:
        k8, v8 = k.astype(ml_dtypes.float8_e4m3fn), v.astype(ml_dtypes.float8_e4m3fn)
        jk, jv = jnp.asarray(k8), jnp.asarray(v8)
        tk = torch.tensor(k).to(torch.float8_e4m3fn)
        tv = torch.tensor(v).to(torch.float8_e4m3fn)
        np.testing.assert_array_equal(_np(tk), k8.astype(np.float32))
    ref, rk, rv = jax_decode_layer.fused_decode_trunk_flat(
        jgpt, jnp.asarray(hidden), jk, jv, jnp.int32(position), jnp.asarray(mask), heads=4,
        interpret=True)
    got, gk, gv = decode_layer.fused_decode_trunk_flat(
        tgpt, torch.from_numpy(hidden), tk, tv, position, torch.from_numpy(mask), 4)
    assert decode_layer.fused_decode_trunk_flat.launches == 0
    assert gk is tk and gk.dtype == (torch.float8_e4m3fn if tier == "fp8_cache"
                                     else torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=TOL, rtol=0)
    for g_c, r_c in ((gk, rk), (gv, rv)):
        g_c, r_c = _np(g_c), np.asarray(r_c).astype(np.float32)
        rows = np.arange(T) != position
        np.testing.assert_array_equal(g_c[:, rows], r_c[:, rows])   # untouched
        if tier == "fp8_cache":   # one e4m3 step: 2^-3 relative, 2^-9 absolute
            np.testing.assert_allclose(g_c[:, position], r_c[:, position], rtol=2 ** -3,
                                       atol=2 ** -9)
        else:
            np.testing.assert_allclose(g_c[:, position], r_c[:, position], atol=TOL, rtol=0)
