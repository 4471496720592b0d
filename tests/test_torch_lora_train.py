"""PyTorch port, LoRA training step: `train_forward`, `loss_fn` and its LoRA
gradients, the optimizer (clip, LoRA+ AdamW, warmup-cosine schedule,
gradient accumulation) over three updates, `merge`, the non-finite true
skip, `top_k_accuracy`'s tie order and CFG dropout, all held against the
JAX package (`unified_voice.train_forward`, `trainer.loss_fn` under
`jax.value_and_grad`, `trainer.train_step` with `make_optimizer`,
`lora.merge`) on the same numpy-seeded weights, adapters and batches.
Tiny config (2 layers, width 64, 4 heads), fp32 unless a case says
otherwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.train import lora as jax_lora
from indextts_tpu.train import trainer as jax_trainer
from indextts_tpu_torch.config import GPTConfig, LoRAConfig, TrainConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import unified_voice as uv
from indextts_tpu_torch.train import lora, trainer
from tests.test_torch_gpt import TINY, gpt_numpy_params

# fp32 on both sides: products and softmax differ only in summation order
TOL = 1e-5
TEXT_WEIGHT = 0.1


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    else:
        yield path, _np(tree)


def assert_close(got, want, rel=TOL, what=""):
    """Each leaf within `rel` of the leaf's largest magnitude."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w), what
    for k in w:
        scale = max(float(np.abs(w[k]).max()), 1e-30)
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= rel * scale, f"{what}{k}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


def numpy_lora(jcfg, jlora, seed, b_std=0.05):
    """JAX's own init (PRNGKey(seed)) for `a`, and `b` drawn from numpy, so
    that both factors have gradients."""
    params = jax.tree.map(np.asarray, jax_lora.init_lora_params(
        jax.random.PRNGKey(seed), jcfg, jlora))
    rng = np.random.default_rng(seed)
    for ab in params.values():
        ab["b"] = (b_std * rng.standard_normal(ab["b"].shape)).astype(np.float32)
    return params


def numpy_batch(seed, B=3, n_text=40, n_codes=46):
    """Right-padded to fixed widths (8 text, 12 codes, 40 mel frames), so
    that every batch runs one compiled JAX program."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(3, 8, B).astype(np.int32)
    cl = rng.integers(5, 11, B).astype(np.int32)
    ml = rng.integers(24, 40, B).astype(np.int32)
    text = np.zeros((B, 8), np.int32)
    codes = np.zeros((B, 12), np.int32)
    cond = np.zeros((B, 100, 40), np.float32)
    for i in range(B):
        text[i, :tl[i]] = rng.integers(2, n_text, tl[i])
        codes[i, :cl[i]] = rng.integers(0, n_codes, cl[i])
        cond[i, :, :ml[i]] = rng.standard_normal((100, ml[i]))
    return dict(text_ids=text, text_lengths=tl, mel_codes=codes, codes_lengths=cl,
                cond_mel=cond, cond_lengths=ml)


def start_state(optimizer, adapters):
    return trainer.TrainState(adapters, optimizer.init(adapters),
                              torch.zeros((), dtype=torch.int32))


def jax_batch(b):
    return jax_trainer.Batch(**{k: jnp.asarray(v) for k, v in b.items()})


def torch_batch(b):
    return trainer.Batch(**{k: torch.from_numpy(v).to(torch.float32 if v.dtype == np.float32
                                                     else torch.int64)
                            for k, v in b.items()})


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    tcfg = GPTConfig.from_dict(TINY)
    jlora, tlora = jax_config.LoRAConfig(), LoRAConfig()
    base_np = gpt_numpy_params(jcfg)
    lora_np = numpy_lora(jcfg, jlora, 3)
    return dict(jcfg=jcfg, tcfg=tcfg, jlora=jlora, tlora=tlora, base_np=base_np,
                lora_np=lora_np, jbase=jax.tree.map(jnp.asarray, base_np),
                tbase=from_jax.gpt_params_from_numpy(base_np, tcfg),
                jadapt=jax.tree.map(jnp.asarray, lora_np),
                tadapt=from_jax.lora_params_from_numpy(lora_np, tcfg, tlora),
                batches=[numpy_batch(10 + i) for i in range(2)])


def test_lora_params_from_numpy_checks_the_layout(setup):
    s = setup
    bad = {k: dict(v) for k, v in s["lora_np"].items()}
    bad["attn.c_attn"]["a"] = bad["attn.c_attn"]["a"][:, :, :2]
    with pytest.raises(ValueError, match="attn.c_attn.a"):
        from_jax.lora_params_from_numpy(bad, s["tcfg"], s["tlora"])


_jax_train_forward = jax.jit(jax_uv.train_forward, static_argnames=("cfg",))


def test_train_forward_matches_jax(setup):
    s = setup
    b = s["batches"][0]
    rng = np.random.default_rng(5)
    cond = rng.standard_normal((3, 32, 64)).astype(np.float32)
    jp = jax_lora.materialize(s["jbase"], s["jadapt"], s["jlora"])
    want = _jax_train_forward(jp, s["jcfg"], jnp.asarray(cond), *(
        jnp.asarray(b[k]) for k in ("text_ids", "text_lengths", "mel_codes", "codes_lengths")))
    tb = torch_batch(b)
    tp = lora.materialize(s["tbase"], s["tadapt"], s["tlora"])
    got = uv.train_forward(tp, s["tcfg"], torch.from_numpy(cond), tb.text_ids,
                           tb.text_lengths, tb.mel_codes, tb.codes_lengths)
    for k in ("text_targets", "text_mask", "mel_targets", "mel_mask"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    for k in ("loss_text", "loss_mel", "text_logits", "mel_logits"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=k)


_jax_value_and_grad = jax.jit(
    jax.value_and_grad(jax_trainer.loss_fn, has_aux=True),
    static_argnames=("cfg", "lora_cfg", "text_weight", "cfg_dropout_ratio"))


def _jax_loss_grads(s, jbase, jadapt, b, ratio=0.0):
    (loss, metrics), grads = _jax_value_and_grad(
        jadapt, jbase, jax_batch(b), jax.random.PRNGKey(0), cfg=s["jcfg"],
        lora_cfg=s["jlora"], text_weight=TEXT_WEIGHT, cfg_dropout_ratio=ratio)
    return loss, metrics, grads


def _torch_loss_grads(s, tbase, tadapt, b, ratio=0.0):
    state = trainer.TrainState(tadapt, {}, torch.zeros((), dtype=torch.int32))
    return trainer.loss_and_grads(state, tbase, torch_batch(b), s["tcfg"], s["tlora"],
                                  TEXT_WEIGHT, ratio, torch.Generator().manual_seed(0))


def test_loss_and_lora_grads_match_jax(setup):
    s = setup
    b = s["batches"][1]
    jl, jm, jg = _jax_loss_grads(s, s["jbase"], s["jadapt"], b)
    tl, tm, tg = _torch_loss_grads(s, s["tbase"], s["tadapt"], b)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    for k in ("loss_text", "loss_mel", "acc_1", "acc_10", "acc_20"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, err_msg=k)
    assert_close(tg, jax.tree.map(np.asarray, jg), what="grads")


@pytest.mark.parametrize("ratio", [0.0, 1.0])
def test_cfg_dropout_at_ratios_0_and_1(setup, ratio):
    """At 0 the conditioning stays; at 1 every draw drops it (other ratios'
    draws come from different generators)."""
    s = setup
    b = s["batches"][0]
    jl, _, jg = _jax_loss_grads(s, s["jbase"], s["jadapt"], b, ratio)
    tl, _, tg = _torch_loss_grads(s, s["tbase"], s["tadapt"], b, ratio)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    assert_close(tg, jax.tree.map(np.asarray, jg), what=f"ratio {ratio} grads")
    if ratio:
        kept, _, _ = _torch_loss_grads(s, s["tbase"], s["tadapt"], b, 0.0)
        assert abs(float(kept) - float(tl)) > 1e-4


def _train_cfgs(accum, max_grad_norm, lr=1e-2):
    d = {"gradient_accumulation_steps": accum, "max_grad_norm": max_grad_norm,
         "optimizer": {"learning_rate": lr, "weight_decay": 0.01, "warmup_ratio": 0.34,
                       "loraplus_lr_ratio": 2.0}}
    return jax_config.TrainConfig.from_dict(d), TrainConfig.from_dict(d)


@pytest.mark.parametrize("accum", [2, 1])
def test_optimizer_matches_optax_on_equal_gradients(setup, accum):
    """The optimizer alone, fed the same gradients as JAX's make_optimizer
    chain: three updates (six micro-steps at accumulation 2) with the clip
    firing, adapters within 1e-6 of optax's after every micro-step; the
    schedule equal to optax's at every count (lr 0 at the first update)."""
    import optax

    s = setup
    updates = 3
    jtc, ttc = _train_cfgs(accum, max_grad_norm=0.05)
    jopt = jax_trainer.make_optimizer(jtc, updates)
    topt = trainer.make_optimizer(ttc, updates)
    jp, tp = s["jadapt"], s["tadapt"]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    rng = np.random.default_rng(accum)
    for i in range(updates * accum):
        g = {k: {kk: (0.1 * rng.standard_normal(vv.shape)).astype(np.float32)
                 for kk, vv in v.items()} for k, v in s["lora_np"].items()}
        u, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, u)
        tp, tstate = topt.step(from_jax.lora_params_from_numpy(g, s["tcfg"], s["tlora"]),
                               tstate, tp)
        assert_close(tp, jax.tree.map(np.asarray, jp), rel=1e-6, what=f"micro-step {i}: ")
    assert int(tstate["count"]) == updates
    warm = max(1, int(updates * jtc.optimizer.warmup_ratio))
    for grp, peak in (("a", 1e-2), ("b", 2e-2)):
        sched = optax.warmup_cosine_decay_schedule(0.0, peak, warm, max(updates, warm + 1), 0.0)
        for count in range(updates + 2):
            got = topt.learning_rate(torch.tensor(count, dtype=torch.int32), grp)
            np.testing.assert_allclose(float(got), float(sched(count)), rtol=1e-6, atol=1e-12)


def test_train_steps_match_jax(setup, accum=2):
    """Three updates through train_step (six micro-steps at accumulation 2)
    at the reference learning rate, 5e-6, with the clip firing: the adapters
    after every micro-step within 1e-5 of JAX's train_step with
    make_optimizer, and a micro-step inside an accumulation moves nothing.
    (Adam scales each element to about lr, so an element whose gradient is
    near zero turns summation-order noise into up to 2 lr: the rate sets how
    close two correct runs can be.)"""
    s = setup
    updates = 3
    jtc, ttc = _train_cfgs(accum, max_grad_norm=0.05, lr=5e-6)
    jopt = jax_trainer.make_optimizer(jtc, updates)
    topt = trainer.make_optimizer(ttc, updates)
    # train_step donates its state: JAX's gets copies
    jstate = jax_trainer.TrainState(jax.tree.map(jnp.array, s["jadapt"]),
                                    jopt.init(s["jadapt"]), jnp.int32(0))
    tstate = start_state(topt, s["tadapt"])
    before = dict(_leaves(tstate.lora_params))
    for i in range(updates * accum):
        b = s["batches"][i % 2]
        jstate, jm = jax_trainer.train_step(
            jstate, s["jbase"], jax_batch(b), jax.random.PRNGKey(i), s["jcfg"], s["jlora"],
            jopt, TEXT_WEIGHT, 0.0)
        tstate, tm = trainer.train_step(tstate, s["tbase"], torch_batch(b), s["tcfg"],
                                        s["tlora"], topt, TEXT_WEIGHT)
        assert float(tm["grad_norm"]) > 10 * ttc.max_grad_norm    # the clip fires
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=TOL)
        assert_close(tstate.lora_params, jax.tree.map(np.asarray, jstate.lora_params),
                     what=f"micro-step {i}: ")
        now = dict(_leaves(tstate.lora_params))
        if (i + 1) % accum:
            for k in now:
                np.testing.assert_array_equal(now[k], before[k], err_msg=k)
        before = now
        assert int(tstate.step) == int(jstate.step) == i + 1


def test_non_finite_loss_is_a_true_skip(setup):
    """A NaN base weight makes the loss NaN: the adapters, the optimizer state
    (moments, count, accumulator, mini-step) and the step stay as they were,
    and the metrics say so."""
    s = setup
    _, ttc = _train_cfgs(2, 1.0)
    opt = trainer.make_optimizer(ttc, 4)
    state = start_state(opt, s["tadapt"])
    state, _ = trainer.train_step(state, s["tbase"], torch_batch(s["batches"][0]), s["tcfg"],
                                  s["tlora"], opt, TEXT_WEIGHT)
    assert int(state.opt_state["mini_step"]) == 1
    bad = lora.tree_map(lambda x: x.clone(), s["tbase"])
    bad["gpt"]["blocks"]["mlp"]["fc_w"][0, 3, 5] = float("nan")
    after, m = trainer.train_step(state, bad, torch_batch(s["batches"][1]), s["tcfg"],
                                  s["tlora"], opt, TEXT_WEIGHT)
    assert not np.isfinite(float(m["loss"])) and float(m["skipped"]) == 1.0
    assert float(m["grad_norm"]) == 0.0
    for tree_got, tree_want in ((after.lora_params, state.lora_params),
                                (after.opt_state, state.opt_state)):
        got, want = dict(_leaves(tree_got)), dict(_leaves(tree_want))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(after.step) == int(state.step) == 1


def test_merge_matches_jax(setup):
    """fp32 merge bit-equal to JAX's; the bf16 save equal too."""
    s = setup
    both = jax.jit(lambda b, a: [jax_lora.merge(b, a, s["jlora"], dt)
                                 for dt in (jnp.float32, jnp.bfloat16)])
    for merged, tdt in zip(both(s["jbase"], s["jadapt"]), (torch.float32, torch.bfloat16)):
        want = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), merged)
        got = lora.merge(s["tbase"], s["tadapt"], s["tlora"], tdt)
        assert got["gpt"]["blocks"]["attn"]["qkv_w"].dtype == tdt
        g, w = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{tdt} {k}")


def test_top_k_accuracy_takes_jax_tie_order():
    """bf16 logits with planted ties at the top-1/10/20 cut: the lower
    index wins among equals, as `lax.top_k` orders them."""
    rng = np.random.default_rng(7)
    B, T, V = 2, 9, 50
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, T))
    for b in range(B):
        for t in range(T):
            order = np.argsort(-logits[b, t], kind="stable")
            cut = order[[0, 9, 19][t % 3]]
            tie = (cut + 1 + t) % V          # an index tied with the last kept one
            logits[b, t, tie] = logits[b, t, cut]
            targets[b, t] = max(cut, tie) if t % 2 else min(cut, tie)
    logits = np.asarray(jnp.asarray(logits).astype(jnp.bfloat16).astype(jnp.float32))
    mask = rng.random((B, T)) < 0.8
    want = jax_uv.top_k_accuracy(jnp.asarray(logits).astype(jnp.bfloat16),
                                 jnp.asarray(targets), jnp.asarray(mask))
    got = uv.top_k_accuracy(torch.from_numpy(logits).to(torch.bfloat16),
                            torch.from_numpy(targets), torch.from_numpy(mask))
    for k in want:
        assert float(got[k]) == float(want[k]), k


def test_bf16_base_matches_jax_within_its_tolerance(setup):
    """A bf16 base (the trainer's mixed precision): the adapters fold into
    bf16 weights and the forward runs in bf16.  Losses within 1% and logits
    within 5% of their largest magnitude of JAX's: bf16 activations round
    differently after other summation orders, so fp32's tolerance does not
    apply."""
    s = setup
    b = s["batches"][0]
    cond = np.random.default_rng(5).standard_normal((3, 32, 64)).astype(np.float32)
    jbase = jax.tree.map(lambda x: x.astype(jnp.bfloat16), s["jbase"])
    tbase = lora.tree_map(lambda x: x.to(torch.bfloat16), s["tbase"])
    jp = jax_lora.materialize(jbase, s["jadapt"], s["jlora"])
    tp = lora.materialize(tbase, s["tadapt"], s["tlora"])
    assert tp["gpt"]["blocks"]["attn"]["qkv_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tp["gpt"]["blocks"]["attn"]["qkv_w"]),
                                  np.asarray(jp["gpt"]["blocks"]["attn"]["qkv_w"]
                                             .astype(jnp.float32)))
    want = _jax_train_forward(jp, s["jcfg"], jnp.asarray(cond).astype(jnp.bfloat16), *(
        jnp.asarray(b[k]) for k in ("text_ids", "text_lengths", "mel_codes", "codes_lengths")))
    tb = torch_batch(b)
    got = uv.train_forward(tp, s["tcfg"], torch.from_numpy(cond).to(torch.bfloat16),
                           tb.text_ids, tb.text_lengths, tb.mel_codes, tb.codes_lengths)
    for k in ("loss_text", "loss_mel"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-2, err_msg=k)
    for k in ("text_logits", "mel_logits"):
        w = np.asarray(want[k].astype(jnp.float32))
        assert np.abs(_np(got[k]) - w).max() <= 5e-2 * np.abs(w).max(), k
