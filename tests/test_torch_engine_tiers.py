"""PyTorch port, engine precision tiers: int8 and int4 weights decode the same
greedy codes as the JAX engine on the same weights (single row, through the
decode-trunk kernel on both sides), and the precision keys resolve as in the
JAX engine."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_engine import TEXT, build_engines, model  # noqa: F401  (fixture)


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_engine_greedy_codes_match_jax(model, tier):  # noqa: F811
    """int8/int4 weights, num_beams=1.  The JAX engine takes its fused trunk
    (the TPU kernel in interpret mode) on its fused-layout tree, as the
    port's engine takes K2's plain version: the same weight grid.  Compute
    is fp32 (quantization.enabled with gpt=fp32): under gpt=int8/int4 both
    compute in bf16, but the TPU kernel rounds activations to bf16 before
    each product where the port's kernel keeps them fp32, and greedy codes
    then part after a few steps."""
    jeng, teng = build_engines(model, {"gpt": "fp32", "vocoder": "fp32",
                                       "quantization": {"enabled": True,
                                                        "weight_dtype": tier}})
    assert teng.use_quantization and teng.quant_weight_dtype == tier
    blocks = teng.gpt_params["gpt"]["blocks"]
    assert set(blocks["mlp"]["proj_w"]) == ({"q", "s"} if tier == "int8" else {"q4", "s"})
    if tier == "int4":
        assert set(teng.gpt_params_batched["gpt"]["blocks"]["mlp"]["proj_w"]) == {"q4s", "s"}
    mel = teng._prompt_mel(str(model[0] / "prompt.wav"))
    cond = np.asarray(jeng._conditioning(jnp.asarray(mel.numpy()), None), np.float32)
    n_codes = 0
    # fused: K2 on the fused layout, cache in the compute type; not fused
    # (int4 only, to keep the test short): gpt2.decode_step on the shared
    # layout over the fp8 KV cache that quantization turns on
    for fused in ((True, False) if tier == "int4" else (True,)):
        gen = dict(num_beams=1, do_sample=False, max_mel_tokens=12, use_fused_trunk=fused)
        for sent in teng.tokenizer.split_sentences(teng.tokenizer.tokenize(TEXT), 20):
            ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(sent), np.int32)
            jcodes, jlens = jeng._decode_bucket(jnp.asarray(cond), [ids],
                                                jax.random.PRNGKey(0), dict(gen))
            tcodes, tlens, _ = teng._decode_bucket(torch.tensor(cond), [ids], None,
                                                   dict(gen))
            np.testing.assert_array_equal(tcodes, jcodes)
            np.testing.assert_array_equal(tlens, jlens)
            n_codes += int(tlens[0])
    assert n_codes >= 8


@pytest.mark.parametrize("precision", [
    {"gpt": "fp8"}, {"gpt": "int4"}, {"gpt": "int8", "kv_cache": "bf16"},
    {"gpt": "bf16", "quantization": {"enabled": True, "weight_dtype": "int4"}},
    {"gpt": "fp32", "kv_cache": "fp8"}])
def test_precision_keys_resolve_as_in_jax(model, precision):  # noqa: F811
    jeng, teng = build_engines(model, precision)
    names = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    assert names[teng.gpt_dtype] == jnp.dtype(jeng.gpt_dtype).name
    assert teng.use_quantization == jeng.use_quantization
    assert teng.quant_weight_dtype == jeng.quant_weight_dtype
    jkv = jeng.kv_cache_dtype
    assert (teng.kv_cache_dtype is None) == (jkv is None)
    if jkv is not None:
        assert teng.kv_cache_dtype == torch.float8_e4m3fn and jnp.dtype(jkv).name == \
            "float8_e4m3fn"
    if precision["gpt"] == "fp8":   # fp8 only maps to bf16 compute: no quantization
        assert teng.gpt_dtype == torch.bfloat16 and not teng.use_quantization
