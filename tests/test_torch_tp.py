"""PyTorch port, tensor-parallel serving (parallel/tp.py, the TP group of
parallel/mesh.py, the group through models/gpt2.py, models/unified_voice.py
and engine.py, `--tp` in the CLI and the server, tools/entry.tp_check), on
gloo ranks on the CPU.

Two ranks, each a process: one engine at tp = 2 (this process rank 0, one
follower it starts), whose group also runs the model-level cases on both
ranks through the engine's `_on_ranks`.  At tp = 2 every case is held
against the JAX package's unsharded function on the same numpy-seeded
weights: the trunk's forward on plain, int8, shared-int4 and fused-int4
weights within JAX's own tolerance for its sharded forward
(tests/test_multichip.py: rtol 2e-4, atol 2e-5, `TOL`), and the greedy,
beam-3 and guided decodes' codes equal.  Every collective and every
spawn has a deadline.  The follower imports this file, so the JAX side is
imported where it is used (`_jax`), as in tests/test_torch_parallel.py."""

import json
import os
import shutil
import threading
import time
import types
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from indextts_tpu_torch import cli
from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import gpt2
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.ops import quantization
from indextts_tpu_torch.parallel import mesh, multihost, tp
from indextts_tpu_torch.serve import httpd

TOL = dict(rtol=2e-4, atol=2e-5)   # JAX's sharded-forward tolerance (tests/test_multichip.py)
DEADLINE_S = 120.0
FORMS = ("plain", "int8", "int4shared", "int4")
DECODE = dict(max_new=16, do_sample=False, repetition_penalty=1.0)
FP32 = {"gpt": "fp32", "vocoder": "fp32"}


def _jax():
    """The JAX package and the shared test helpers (which import JAX), in
    the test process only."""
    import jax
    import jax.numpy as jnp

    from indextts_tpu import config, engine
    from indextts_tpu.models import bigvgan, gpt2 as jgpt2, unified_voice
    from tests import test_torch_engine, test_torch_gpt

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, config=config, engine=engine, bigvgan=bigvgan, gpt2=jgpt2,
        uv=unified_voice, numpy_params=test_torch_gpt.numpy_params,
        TINY=test_torch_gpt.TINY, MODEL=test_torch_engine.MODEL, TEXT=test_torch_engine.TEXT,
        GEN=test_torch_engine.GEN)


def _trunk_trees():
    """The JAX package's trunk at the layers of tests/test_multichip.py (2
    layers, width 64, 4 heads) from numpy seed 0, in each weight form, as
    numpy trees (quantized by the port, whose integers and scales are the
    JAX package's: tests/test_torch_quant.py)."""
    J = _jax()
    size = J.gpt2.GPT2Size(layers=2, dim=64, heads=4)
    shapes = J.jax.eval_shape(lambda: J.gpt2.init_gpt2_params(J.jax.random.PRNGKey(0), size))
    plain = J.numpy_params(shapes, 0, lambda s: 1.0 / np.sqrt(s[-2]))
    out = {"plain": plain}
    for form in FORMS[1:]:
        q = quantization.quantize_gpt_params(
            {"gpt": _torch_tree(plain)}, bits=8 if form == "int8" else 4,
            int4_layout="shared" if form == "int4shared" else "fused")["gpt"]
        out[form] = _numpy_tree(q)
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _prompt(seed, n=8):
    rng = np.random.default_rng(seed)
    cond = rng.standard_normal((1, 32, 64)).astype(np.float32)
    prep = uv.prepare_text_prompt([rng.integers(2, 40, (n,))], 0, 1)
    return cond, prep.text_tokens, prep.attn_text


def _rank_cases(engine, payload):
    """One rank's share of the model-level cases, on its shards, over the
    engine's group."""
    group = engine.tp_group
    r, n = group.rank, group.size
    out = {"rank": r}
    x = torch.from_numpy(payload["x"])
    size = gpt2.GPT2Size(layers=2, dim=64, heads=4)
    for form, tree in payload["trunks"].items():
        before = group.all_reduces
        shard = tp.shard_gpt_params(_torch_tree(tree), r, n)
        out[f"forward {form}"] = gpt2.forward(shard, x, None, size, group=group).numpy()
        out[f"forward {form} all_reduces"] = group.all_reduces - before
    tcfg = GPTConfig.from_dict(payload["cfg"])
    params = tp.shard_uv_params(from_jax.gpt_params_from_numpy(payload["uv"], tcfg), r, n)
    cond, tokens, mask = (torch.from_numpy(a) for a in payload["prompt"])
    tokens = tokens.long()
    kw = dict(DECODE, cache_dtype=torch.float32, group=group)
    before = group.all_reduces
    res = uv.inference_speech(params, tcfg, cond, tokens, mask, None, **kw)
    out["greedy"] = (res.codes.numpy(), res.lengths.numpy(), res.steps,
                     group.all_reduces - before)
    res = uv.inference_speech(params, tcfg, cond, tokens, mask, None, cfg_scale=2.0, **kw)
    out["guided"] = (res.codes.numpy(), res.lengths.numpy())
    for reorder in ("lineage", "pallas"):
        res = uv.inference_speech_beam(params, tcfg, cond, tokens, mask, None, num_beams=3,
                                       reorder=reorder, **kw)
        out[f"beam {reorder}"] = (res.codes.numpy(), res.lengths.numpy())
    lt = payload["latent"]
    out["latent"] = uv.latent_forward(params, tcfg, cond, *(torch.from_numpy(a) for a in lt),
                                      group=group).numpy()
    try:                                          # a planted disagreement
        group.check_same(torch.tensor([r]), "a planted value")
        out["planted"] = None
    except RuntimeError as e:
        out["planted"] = str(e)
    out["after_planted"] = group.all_reduce(torch.ones(1)).item()   # the group still works
    return out


def _counts(engine, reset: bool = False):
    """This rank's group counts and trunk bytes; `reset` zeroes the counts
    after reading them."""
    g = engine.tp_group
    out = {"all_reduces": g.all_reduces, "agreements": g.agreements,
           "trunk_bytes": sum(t.numel() * t.element_size()
                              for t in mesh._flatten(engine.gpt_params_batched["gpt"])[0])}
    if reset:
        g.all_reduces = g.agreements = 0
    return out


def _checksum(engine):
    return multihost.tree_checksum(engine.gpt_params_batched["gpt"])


@pytest.fixture(scope="module")
def setup(engines):
    J = _jax()
    jcfg = J.config.GPTConfig.from_dict(J.TINY)
    shapes = J.jax.eval_shape(lambda: J.uv.init_params(J.jax.random.PRNGKey(0), jcfg))
    uv_np = J.numpy_params(shapes, 0, lambda s: 1.0 / np.sqrt(s[-2]))
    rng = np.random.default_rng(0)
    latent = (np.asarray([[5, 9, 11, 3, 0, 0]]), np.asarray([4]),
              rng.integers(0, 45, (1, 10)), np.asarray([7]))
    payload = {"trunks": _trunk_trees(), "uv": uv_np, "prompt": _prompt(7), "cfg": J.TINY,
               "x": rng.standard_normal((2, 6, 64)).astype(np.float32), "latent": latent}
    ranks = engines[2]._on_ranks("tests.test_torch_tp:_rank_cases", payload)
    return J, jcfg, J.jax.tree.map(J.jnp.asarray, uv_np), payload, ranks


@pytest.mark.parametrize("form", FORMS)
def test_sharded_forward_matches_jax(setup, form):
    """tests/test_multichip.py:59 and :173 at tp = 2: every weight form's
    sharded forward equals JAX's unsharded forward on each rank, after two
    all-reduces a layer."""
    J, _, _, payload, ranks = setup
    size = J.gpt2.GPT2Size(layers=2, dim=64, heads=4)
    tree = J.jax.tree.map(J.jnp.asarray, payload["trunks"][form])
    ref = np.asarray(J.gpt2.forward(tree, J.jnp.asarray(payload["x"]), None, size))
    for out in ranks:
        np.testing.assert_allclose(out[f"forward {form}"], ref, **TOL)
        assert out[f"forward {form} all_reduces"] == 4
    np.testing.assert_array_equal(ranks[0][f"forward {form}"], ranks[1][f"forward {form}"])


def test_greedy_decode_matches_jax(setup):
    """tests/test_multichip.py:108: greedy codes and lengths of the sharded
    decode equal JAX's unsharded decode, on every rank, with two
    all-reduces a layer for the prefill and for each step."""
    J, jcfg, jp, payload, ranks = setup
    cond, tokens, mask = payload["prompt"]
    ref = J.uv.inference_speech(jp, jcfg, J.jnp.asarray(cond), J.jnp.asarray(tokens),
                                J.jnp.asarray(mask), J.jax.random.PRNGKey(3),
                                cache_dtype=J.jnp.float32, **DECODE)
    for out in ranks:
        codes, lens, steps, reduces = out["greedy"]
        np.testing.assert_array_equal(codes, np.asarray(ref.codes))
        np.testing.assert_array_equal(lens, np.asarray(ref.lengths))
        assert reduces == 2 * 2 * (1 + steps)


def test_guided_decode_matches_jax(setup):
    J, jcfg, jp, payload, ranks = setup
    cond, tokens, mask = payload["prompt"]
    ref = J.uv.inference_speech(jp, jcfg, J.jnp.asarray(cond), J.jnp.asarray(tokens),
                                J.jnp.asarray(mask), J.jax.random.PRNGKey(3),
                                cache_dtype=J.jnp.float32, cfg_scale=2.0, **DECODE)
    for out in ranks:
        np.testing.assert_array_equal(out["guided"][0], np.asarray(ref.codes))
        np.testing.assert_array_equal(out["guided"][1], np.asarray(ref.lengths))


@pytest.mark.parametrize("reorder", ["lineage", "pallas"])
def test_greedy_beam_matches_jax(setup, reorder):
    """Beam-3 on each rank's head-sharded caches (under "pallas" K3's plain
    version reorders them): JAX's unsharded beam codes."""
    J, jcfg, jp, payload, ranks = setup
    cond, tokens, mask = payload["prompt"]
    ref = J.uv.inference_speech_beam(jp, jcfg, J.jnp.asarray(cond), J.jnp.asarray(tokens),
                                     J.jnp.asarray(mask), J.jax.random.PRNGKey(3), num_beams=3,
                                     cache_dtype=J.jnp.float32, **DECODE)
    for out in ranks:
        np.testing.assert_array_equal(out[f"beam {reorder}"][0], np.asarray(ref.codes))
        np.testing.assert_array_equal(out[f"beam {reorder}"][1], np.asarray(ref.lengths))


def test_latent_forward_matches_jax(setup):
    J, jcfg, jp, payload, ranks = setup
    cond = payload["prompt"][0]
    ref = J.uv.latent_forward(jp, jcfg, J.jnp.asarray(cond),
                              *(J.jnp.asarray(a) for a in payload["latent"]))
    for out in ranks:
        np.testing.assert_allclose(out["latent"], np.asarray(ref), **TOL)


def test_a_disagreement_raises_on_every_rank(setup):
    """`check_same` (each decode's last collective): rank 1 holding another
    value than rank 0 raises on both ranks, and the group goes on."""
    for out in setup[4]:
        assert out["planted"] == ("tensor-parallel ranks disagree on a planted value: rank 1 "
                                  "differs from rank 0")
        assert out["after_planted"] == 2.0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("form", FORMS + ("q4n",))
def test_shards_are_the_unsharded_tree(form, n):
    """The shards hold the unsharded tree's integers and scales: qkv split per
    head (rank r: heads [rH/n, (r+1)H/n) of q, of k and of v), fc and its
    bias by contiguous columns, both proj by rows (their scales whole), the
    rest whole; each rank's float weights are the matching slice of the
    whole, for every weight form."""
    trees = _trunk_trees()
    whole = _torch_tree(trees["plain" if form == "q4n" else form])
    if form == "q4n":
        whole = quantization.nativize_int4(
            {"gpt": _torch_tree(trees["int4shared"])})["gpt"]
    shards = [tp.shard_gpt_params(whole, r, n) for r in range(n)]

    def dense(leaf):
        return quantization.dequantize(leaf, torch.float32) if isinstance(leaf, dict) \
            else leaf.float()

    blocks = whole["blocks"]
    D, H = 64, 4
    hd, w = D // H, D // n
    for r, shard in enumerate(shards):
        sb = shard["blocks"]
        qkv = dense(blocks["attn"]["qkv_w"])
        heads = torch.cat([qkv[..., j * D + r * w:j * D + (r + 1) * w] for j in range(3)], -1)
        torch.testing.assert_close(dense(sb["attn"]["qkv_w"]), heads, rtol=0, atol=0)
        per_head = [("qkv_b", blocks["attn"]["qkv_b"], sb["attn"]["qkv_b"])]
        if form != "plain":       # column-parallel scales split with their columns
            per_head.append(("s", blocks["attn"]["qkv_w"]["s"], sb["attn"]["qkv_w"]["s"]))
        for name, b, got in per_head:
            torch.testing.assert_close(got, torch.cat(
                [b[..., j * D + r * w:j * D + (r + 1) * w] for j in range(3)], -1),
                rtol=0, atol=0, msg=name)
        assert w % hd == 0                       # whole heads
        fc = dense(blocks["mlp"]["fc_w"])
        torch.testing.assert_close(dense(sb["mlp"]["fc_w"]), fc[..., r * 4 * w:(r + 1) * 4 * w],
                                   rtol=0, atol=0)
        torch.testing.assert_close(sb["mlp"]["fc_b"],
                                   blocks["mlp"]["fc_b"][..., r * 4 * w:(r + 1) * 4 * w])
        for blk, K in (("attn", D), ("mlp", 4 * D)):
            full = dense(blocks[blk]["proj_w"])
            torch.testing.assert_close(dense(sb[blk]["proj_w"]),
                                       full[..., r * K // n:(r + 1) * K // n, :], rtol=0, atol=0)
            assert sb[blk]["proj_b"] is blocks[blk]["proj_b"]
            if form in ("int8", "int4shared", "q4n"):     # row-parallel scales stay whole
                assert sb[blk]["proj_w"]["s"] is blocks[blk]["proj_w"]["s"]
        assert sb["ln_1"]["scale"] is blocks["ln_1"]["scale"]
        assert shard["ln_f"]["bias"] is whole["ln_f"]["bias"]
    # the integers themselves: the shards' unpacked rows are the whole's
    if form in ("int4shared", "int4"):
        key = "q4s" if form == "int4shared" else "q4"
        lo, hi = quantization.unpack_int4(whole["blocks"]["mlp"]["fc_w"][key])
        for r, shard in enumerate(shards):
            slo, shi = quantization.unpack_int4(shard["blocks"]["mlp"]["fc_w"][key])
            torch.testing.assert_close(slo, lo[..., r * 4 * w:(r + 1) * 4 * w], rtol=0, atol=0)
            torch.testing.assert_close(shi, hi[..., r * 4 * w:(r + 1) * 4 * w], rtol=0, atol=0)


def test_uneven_heads_are_refused():
    with pytest.raises(ValueError, match="does not divide"):
        tp.check_heads(20, 3)
    with pytest.raises(ValueError, match="do not divide"):
        gpt2.local_size(gpt2.GPT2Size(2, 64, 4), type("G", (), {"size": 3})())


# --- the engine at tp = 2 -------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine and the port's engine at tp = 2 (this process rank 0,
    one follower on the CPU) on one numpy-seeded set of weights, over the
    tiny model of tests/test_torch_engine.py."""
    J = _jax()
    d = tmp_path_factory.mktemp("model")
    cfg = J.config.Config.from_dict(J.MODEL)
    cfg.save(str(d / "config.yaml"))
    shutil.copy(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    sr = 24000
    t = np.arange(2 * sr) / sr
    noise = np.random.default_rng(0).standard_normal(t.shape)
    wavfile.write(str(d / "prompt.wav"), sr,
                  ((0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * noise) * 32767).astype(np.int16))
    jax, jnp = J.jax, J.jnp
    gpt_np = J.numpy_params(
        jax.eval_shape(lambda: J.uv.init_params(jax.random.PRNGKey(0), cfg.gpt)), 1,
        lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = J.numpy_params(
        jax.eval_shape(lambda: J.bigvgan.init_params(jax.random.PRNGKey(1), cfg.bigvgan)),
        2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(J.uv, "init_params",
                   lambda key, c, dtype=jnp.float32: jax.tree.map(jnp.asarray, gpt_np))
        mp.setattr(J.bigvgan, "init_params",
                   lambda key, c, dtype=jnp.float32: jax.tree.map(jnp.asarray, bv_np))
        jeng = J.engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                   is_fp16=False, precision_config=FP32)
        teng = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                     device="cpu", is_fp16=False, precision_config=FP32, tp=2)
    teng.load_numpy_params(gpt_np, bv_np)
    yield J, jeng, teng, d, {}
    teng.close()


def _jax_codes(J, jeng, teng, d, **gen):
    """The JAX engine's codes for each sentence of TEXT (its `_decode_bucket`
    on its own conditioning of the prompt), trimmed to their lengths."""
    mel = teng._prompt_mel(str(d / "prompt.wav"))
    cond = jeng._conditioning(J.jnp.asarray(mel.numpy()), None)
    gen = {k: v for k, v in gen.items() if k not in ("max_text_tokens_per_sentence",
                                                     "sentences_bucket_max_size")}
    out = []
    for sent in teng.tokenizer.split_sentences(teng.tokenizer.tokenize(J.TEXT), 20):
        ids = np.asarray(teng.tokenizer.convert_tokens_to_ids(sent), np.int32)
        codes, lens = jeng._decode_bucket(cond, [ids], J.jax.random.PRNGKey(0), dict(gen))
        out.append(np.asarray(codes)[0, :int(np.asarray(lens)[0])])
    return out


def _wavs(J, eng, method, d, tmp_path, tag, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        getattr(eng, method)(str(d / "prompt.wav"), J.TEXT, str(tmp_path / f"{tag}.wav"), **kw)
    return wavfile.read(str(tmp_path / f"{tag}.wav"))[1]


def _jax_infer(engines, tmp_path, gen: str):
    """The JAX engine's `infer` wav for TEXT, greedy or at the default beam-3
    (greedy), computed once a module."""
    J, jeng, _, d, memo = engines
    if gen not in memo:
        kw = _GENS(J)[gen]
        memo[gen] = (_wavs(J, jeng, "infer", d, tmp_path, "jax", **kw),
                     _jax_codes(J, jeng, engines[2], d, **kw))
    return memo[gen]


def _GENS(J):
    return {"greedy": dict(J.GEN),
            "default beam-3": dict(do_sample=False, max_mel_tokens=12,
                                   max_text_tokens_per_sentence=20)}


@pytest.mark.parametrize("gen", ["greedy", "default beam-3"])
def test_engine_infer_matches_jax(engines, tmp_path, gen):
    """`infer` at tp = 2: each sentence's codes, and the wav (one int16 step,
    or four for beam-3, as tests/test_torch_engine.py allows), equal the JAX
    engine's; both ranks ran the decodes and the re-forward (the trunk's
    all-reduces counted alike on each), rank 0 alone the vocoder."""
    J, _, teng, d, _ = engines
    ref, want = _jax_infer(engines, tmp_path, gen)
    teng._on_ranks("tests.test_torch_tp:_counts", True)
    got = _wavs(J, teng, "infer", d, tmp_path, "torch", **_GENS(J)[gen])
    counts = teng._on_ranks("tests.test_torch_tp:_counts")
    assert len(teng.last_stats["codes"]) == len(want) == 2
    for a, b in zip(want, teng.last_stats["codes"]):
        np.testing.assert_array_equal(a, b)
    assert got.shape == ref.shape == (sum(teng.last_stats["code_lens"]) * 1024,)
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= (1 if gen == "greedy"
                                                                         else 4)
    assert counts[0]["all_reduces"] == counts[1]["all_reduces"] > 0
    assert counts[0]["agreements"] == counts[1]["agreements"] > 0
    assert counts[0]["trunk_bytes"] == counts[1]["trunk_bytes"]


def test_engine_infer_fast_and_stream_match_jax(engines, tmp_path):
    """`infer_fast` in two buckets (its decode worker and the re-forward
    take turns on the group) and `infer_stream` (its worker likewise) give
    the JAX engine's codes and wav."""
    J, jeng, teng, d, _ = engines
    kw = dict(J.GEN, sentences_bucket_max_size=1)
    ref = _wavs(J, jeng, "infer_fast", d, tmp_path, "jax", **kw)
    got = _wavs(J, teng, "infer_fast", d, tmp_path, "torch", **kw)
    assert teng.last_stats["buckets"] == [1, 1]
    ref_infer, want = _jax_infer(engines, tmp_path, "greedy")
    for a, b in zip(want, teng.last_stats["codes"]):     # one sentence a bucket
        np.testing.assert_array_equal(a, b)
    assert got.shape == ref.shape and np.abs(got.astype(np.int32)
                                              - ref.astype(np.int32)).max() <= 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        chunks = [c for _, c in teng.infer_stream(str(d / "prompt.wav"), J.TEXT, **J.GEN)]
    ref = ref_infer
    got = np.concatenate(chunks)
    assert len(chunks) == 2 and got.shape == ref.shape
    assert np.abs(got.astype(np.int32) - ref.astype(np.int32)).max() <= 1


def test_engine_checksums_and_pools(engines):
    """Each rank holds its own shard of the same tree (the shards' checksums
    equal those of the engine's tree cut here), and both pools are refused
    under TP with the JAX engine's messages."""
    teng = engines[2]
    sums = teng._on_ranks("tests.test_torch_tp:_checksum")
    assert len(sums) == 2 and sums[0] == multihost.tree_checksum(teng.gpt_params_batched["gpt"])
    assert sums[0] != sums[1]
    with pytest.raises(ValueError, match="not supported with tensor-parallel"):
        teng.create_batcher()
    with pytest.raises(ValueError, match="continuous beam batching is not supported with tp>1"):
        teng.create_beam_batcher()
    with pytest.raises(ValueError, match="mutually exclusive"):
        httpd.TTSService("unused.yaml", "unused", continuous=True, tp=2, device="cpu")


def test_too_few_cards_raise_before_loading(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(from_jax, "gpt_params_from_numpy", lambda *a, **k: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="tp=2 requires 2 devices; only 1 visible"):
        torch_engine.IndexTTS(cfg_path=None, model_dir=str(tmp_path), tp=2)


def test_cli_closes_its_followers(engines, tmp_path, monkeypatch):
    """The CLI with `--tp 2 -d cpu` writes a wav, and its engine's close()
    leaves no follower process (the live follower exits with code 0)."""
    d = engines[3]
    followers = []
    close = torch_engine.IndexTTS.close

    def recording_close(self):
        followers.extend(self._tp.procs)
        close(self)

    monkeypatch.setattr(torch_engine.IndexTTS, "close", recording_close)
    out = tmp_path / "cli.wav"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cli.main(["你好。", "-v", str(d / "prompt.wav"), "-o", str(out), "--model_dir",
                         str(d), "-d", "cpu", "--num_beams", "1", "--tp", "2",
                         "--seed", "3"]) == 0
    sr, wav = wavfile.read(str(out))
    assert sr == 24000 and wav.dtype == np.int16 and wav.shape[0] % 1024 == 0
    assert len(followers) == 1 and [p.poll() for p in followers] == [0]


def test_server_with_tp_and_a_dead_follower(engines):
    """The stdlib server with tp=2, over the module's engine (the last case
    to use it), answers /tts over a socket.  Its follower killed while
    requests run: rank 0 raises within the deadline (an error answer naming
    rank 1, never a hang), the next request gets a new engine and its
    answer, and shutdown leaves no follower process."""
    teng, d = engines[2], engines[3]
    server = httpd.serve(str(d / "config.yaml"), str(d), host="127.0.0.1", port=0, tp=2,
                         device="cpu", engine_instance=teng)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/tts"
    body = json.dumps({"text": "你好。", "audio_path": str(d / "prompt.wav"), "seed": 3,
                       "num_beams": 1, "max_mel_tokens": 12}).encode()

    def tts():
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=DEADLINE_S) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        status, wav = tts()
        assert status == 200 and wav[:4] == b"RIFF"
        followers = list(teng._tp.procs)
        threading.Timer(0.05, followers[0].kill).start()
        t0 = time.monotonic()
        for _ in range(100):
            status, err = tts()
            if status != 200:
                break
        assert status == 500 and b"rank 1" in err, err[:300]
        assert time.monotonic() - t0 < DEADLINE_S / 4
        assert teng.tp_broken is not None
        status, wav = tts()
        assert status == 200 and wav[:4] == b"RIFF"
        assert server.service._tts is not teng and teng.tp_broken
        followers += server.service._tts._tp.procs
    finally:
        server.shutdown()
    assert len(followers) == 2 and all(p.poll() is not None for p in followers)


def test_tp_check_over_two_gloo_ranks():
    """tools/entry.tp_check, the tensor-parallel half of dryrun_multichip:
    the toy trunk's forward and greedy decode over 2 ranks equal one rank's,
    with two all-reduces a layer a step."""
    from indextts_tpu_torch.tools import entry

    out = entry.tp_check(2, "cpu")
    assert out["tp_ok"], out
    assert np.isfinite(out["tp_forward_msq"]) and out["tp_decode_codes"] == 8
    assert out["tp_all_reduces_by_rank"][0] == out["tp_all_reduces_by_rank"][1]
