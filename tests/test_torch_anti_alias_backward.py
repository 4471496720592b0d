"""PyTorch port, the backward of the anti-aliased SnakeBeta (K1b's plain
version, ops/filters.anti_aliased_activation_backward) against jax.vjp of
the JAX package's XLA composition and against torch autograd of the plain
forward (and gradcheck in fp64); the autograd function of
ops/cuda/anti_alias.py (K1 forward, K1b backward), with its launchers
counted, at the op and through a tiny BigVGAN."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu.ops import filters as jax_filters
from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.models import bigvgan
from indextts_tpu_torch.ops import filters
from indextts_tpu_torch.ops.cuda import anti_alias

# T < 6 is where the clamps of both edges overlap; 64 is an interior run
TS = [1, 2, 3, 5, 7, 64]


def _inputs(B, C, T, seed, logscale=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    g = rng.standard_normal((B, C, T)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(C)).astype(np.float32)
    if not logscale:   # the raw parameters are the rates themselves
        alpha, beta = np.abs(alpha) + 0.5, np.abs(beta) + 0.5
    return x, alpha, beta, g


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("T", TS)
def test_plain_backward_matches_jax_vjp(T, logscale):
    x, a, b, g = _inputs(2, 3, T, T, logscale)
    _, vjp = jax.vjp(lambda x_, a_, b_: jax_filters.anti_aliased_activation(
        x_, a_, b_, logscale), jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    ref = vjp(jnp.asarray(g))
    got = filters.anti_aliased_activation_backward(*map(torch.from_numpy, (x, a, b, g)),
                                                   logscale)
    assert got[0].shape == (2, 3, T) and got[1].shape == got[2].shape == (3,)
    # fp32 on both sides, sums in other orders: 1e-5 of each gradient's largest magnitude
    for gt, rf in zip(got, ref):
        assert _rel_err(gt.numpy(), rf) < 1e-5


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("T", TS)
def test_plain_backward_matches_torch_autograd(T, logscale):
    x, a, b, g = (torch.from_numpy(v) for v in _inputs(2, 3, T, 100 + T, logscale))
    leaves = [v.clone().requires_grad_(True) for v in (x, a, b)]
    y = filters.downsample2x(filters.snake_beta(filters.upsample2x(leaves[0]), leaves[1],
                                                leaves[2], logscale))
    ref = torch.autograd.grad(y, leaves, g)
    got = filters.anti_aliased_activation_backward(x, a, b, g, logscale)
    for gt, rf in zip(got, ref):
        assert _rel_err(gt, rf) < 1e-5


class _Fp64Activation(torch.autograd.Function):
    """The composition in fp64 forward, the plain backward backward."""

    @staticmethod
    def forward(ctx, x, alpha, beta, logscale):
        ctx.save_for_backward(x, alpha, beta)
        ctx.logscale = logscale
        return filters.downsample2x(filters.snake_beta(filters.upsample2x(x), alpha, beta,
                                                       logscale))

    @staticmethod
    def backward(ctx, g):
        return (*filters.anti_aliased_activation_backward(*ctx.saved_tensors, g, ctx.logscale),
                None)


@pytest.mark.parametrize("logscale", [True, False])
@pytest.mark.parametrize("T", [1, 4, 9])
def test_plain_backward_gradcheck_fp64(T, logscale):
    """In fp64 the plain backward is the composition's exact gradient."""
    x, a, b, _ = (torch.from_numpy(v.astype(np.float64)) for v in _inputs(1, 2, T, 7, logscale))
    assert torch.autograd.gradcheck(
        lambda x_, a_, b_: _Fp64Activation.apply(x_, a_, b_, logscale),
        tuple(v.requires_grad_(True) for v in (x, a, b)), eps=1e-6, atol=1e-8, rtol=1e-6)


def test_autograd_function_wiring(monkeypatch):
    """The forward runs K1's launcher once and keeps x, alpha and beta; the
    backward runs K1b's once with them.  Launchers counted here, on their
    plain versions; no launch counter moves on CPU tensors."""
    calls = {"k1": 0, "k1b": 0}
    forward, backward = anti_alias._forward, anti_alias.anti_alias_activation_backward

    def k1(*a):
        calls["k1"] += 1
        return forward(*a)

    def k1b(*a):
        calls["k1b"] += 1
        return backward(*a)

    monkeypatch.setattr(anti_alias, "_forward", k1)
    monkeypatch.setattr(anti_alias, "anti_alias_activation_backward", k1b)
    x, a, b, g = (torch.from_numpy(v) for v in _inputs(2, 4, 33, 3))
    xs, as_, bs = (v.clone().requires_grad_(True) for v in (x, a, b))
    y = anti_alias.fused_anti_alias_activation(xs, as_, bs)
    assert calls == {"k1": 1, "k1b": 0}
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and all(s is v for s, v in zip(saved, (xs, as_, bs)))
    torch.testing.assert_close(y, filters.anti_aliased_activation(x, a, b), rtol=0, atol=0)
    y.backward(g)
    assert calls == {"k1": 1, "k1b": 1}
    ref = filters.anti_aliased_activation_backward(x, a, b, g)
    for got, want in zip((xs.grad, as_.grad, bs.grad), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # no gradient wanted: K1 alone, nothing saved
    with torch.no_grad():
        y2 = anti_alias.fused_anti_alias_activation(xs, as_, bs)
    assert y2.grad_fn is None and calls == {"k1": 2, "k1b": 1}
    y3 = anti_alias.fused_anti_alias_activation(x, a, b)
    assert y3.grad_fn is None and calls == {"k1": 3, "k1b": 1}
    assert anti_alias.fused_anti_alias_activation.launches == 0
    assert backward.launches == 0


def test_backward_wrapper_refuses_other_devices():
    x = torch.empty((1, 2, 8), device="meta")
    a = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        anti_alias.anti_alias_activation_backward(x, a, a, x)


TINY = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=8,
            resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]],
            speaker_embedding_dim=8, gpt_dim=16)


def test_bigvgan_gradient_goes_through_every_activation(monkeypatch):
    """Through a tiny generator every activation runs the autograd function
    (the backward once per activation), and the gradients of conv_pre, of
    every alpha and beta and of the latent equal torch autograd through the
    plain composition (fp32, 1e-5 of each leaf's largest magnitude)."""
    cfg = BigVGANConfig(**TINY)
    params = bigvgan.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    for act in [a for blk in params["resblocks"] for a in blk["acts"]] + [params["activation_post"]]:
        act["alpha"] = torch.from_numpy((0.3 * rng.standard_normal(act["alpha"].shape)).astype(np.float32))
        act["beta"] = torch.from_numpy((0.3 * rng.standard_normal(act["beta"].shape)).astype(np.float32))
    latent = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    mel = torch.from_numpy(rng.standard_normal((2, 20, 100)).astype(np.float32))
    target = torch.from_numpy(rng.standard_normal((2, 1, 20)).astype(np.float32))

    def grads():
        leaves = [params["conv_pre"]["w"]] + [a[k] for blk in params["resblocks"]
                                             for a in blk["acts"] for k in ("alpha", "beta")]
        leaves = [p.clone().requires_grad_(True) for p in leaves]
        lat = latent.clone().requires_grad_(True)
        p2 = {**params, "conv_pre": {**params["conv_pre"], "w": leaves[0]},
              "resblocks": [{**blk, "acts": [{"alpha": leaves[1 + 2 * (i * 4 + j)],
                                              "beta": leaves[2 + 2 * (i * 4 + j)]}
                                             for j in range(4)]}
                            for i, blk in enumerate(params["resblocks"])]}
        wav = bigvgan.forward(p2, lat, mel, cfg)
        loss = ((wav - target) ** 2).mean()
        return torch.autograd.grad(loss, leaves + [lat])

    n_back = [0]
    backward = anti_alias.anti_alias_activation_backward

    def k1b(*a):
        n_back[0] += 1
        return backward(*a)

    monkeypatch.setattr(anti_alias, "anti_alias_activation_backward", k1b)
    got = grads()
    n_acts = len(cfg.upsample_rates) * 4 + 1
    assert n_back[0] == n_acts
    monkeypatch.setattr(anti_alias, "fused_anti_alias_activation",
                        lambda x, a, b, logscale=True: filters.anti_aliased_activation(
                            x, a, b, logscale))
    ref = grads()
    assert n_back[0] == n_acts
    for g, r in zip(got, ref):
        assert float(r.abs().max()) > 0
        assert _rel_err(g.numpy(), r.numpy()) < 1e-5


# K1b's work split (ops/cuda/anti_alias.backward_plan; the kernel's index
# arithmetic restated in _slots and _sum_order): the six stage shapes of a
# vocoder training step and short, odd and ragged rows; on a card of 132
# SMs holding 8 blocks each, on one SM holding one (long-lived segments,
# ragged last pieces) and with 3 steps forced.  The layout (columns a
# thread, threads a block) is read from the kernel's source.
_K1B_SOURCE = (Path(anti_alias.__file__).parents[2] / "csrc"
               / "anti_alias_backward.cu").read_text()
LAYOUT = tuple(int(re.search(rf"constexpr int {name} = (\d+);", _K1B_SOURCE).group(1))
               for name in ("kV", "kThreads"))
SPLIT_SHAPES = ([(8, 768, 96), (8, 384, 384), (8, 192, 1536), (8, 96, 6144), (8, 48, 12288),
                 (8, 24, 24576)] + [(2, 3, T) for T in (1, 2, 3, 5, 7, 95, 96, 257, 6143)])
SPLIT_CARDS = {"h100": dict(sms=132, resident=8), "one_sm": dict(sms=1, resident=1),
               "steps3": dict(sms=132, resident=8, steps=3)}


def _slots(plan: dict) -> dict:
    """The work split that K1b runs for `plan`, by the kernel's own index
    arithmetic: for every (segment, step) that runs, its `row` and `first`
    column (its lanes own the column slots from there, clipped to the
    row) and `into`, the partial its terms go to; and `partial`, the index
    of every partial the kernel writes, in the order of (segment, step)."""
    seg = np.arange(plan["segments"])[:, None]
    t = np.arange(plan["steps"])[None, :]
    steps, pieces = plan["steps"], plan["pieces"]
    if plan["multi_row"]:
        row = seg * steps + t
        chunk = np.zeros_like(row)
        runs = row < plan["rows"]
        flush, index = runs, row
    else:
        row = np.broadcast_to(seg // pieces, (plan["segments"], steps))
        chunk0 = (seg % pieces) * steps
        chunk = chunk0 + t
        runs = chunk < plan["chunks"]
        n_steps = np.minimum(steps, plan["chunks"] - chunk0)
        flush = runs & (t == n_steps - 1)
        index = np.broadcast_to(seg, row.shape)
    return {"row": row[runs], "first": chunk[runs] * plan["span"], "into": index[runs],
            "partial": index[flush]}


def _sum_order(plan: dict):
    """The partial indices that K1b's second kernel adds for each channel,
    in its order: [C, B x pieces] (rows (b, ch) for b < B, pieces in order)."""
    B, C, pieces = plan["B"], plan["C"], plan["pieces"]
    b = np.arange(B)[:, None]
    p = np.arange(pieces)[None, :]
    ch = np.arange(C)[:, None, None]
    return ((b[None] * C + ch) * pieces + p[None]).reshape(C, B * pieces)


@pytest.mark.parametrize("card", list(SPLIT_CARDS))
@pytest.mark.parametrize("B,C,T", SPLIT_SHAPES)
def test_backward_work_split(B, C, T, card):
    """Every column of every row is owned by exactly one thread-slot
    (segment, step, lane); every (row, piece) partial is written exactly
    once; the second kernel sums each channel's partials, and only them, in
    one fixed order; summed so, per-column values give each channel's sum."""
    plan = anti_alias.backward_plan(B, C, T, T % 4 == 0, **SPLIT_CARDS[card], layout=LAYOUT)
    rows, lanes, cols = B * C, plan["seg_lanes"], LAYOUT[0]
    assert lanes in (8, 16, 32) and plan["span"] == lanes * cols
    assert plan["multi_row"] == (T <= plan["span"]) and (lanes == 32 or plan["multi_row"])
    assert plan["blocks"] * LAYOUT[1] // lanes >= plan["segments"]
    slots = _slots(plan)
    assert ((slots["row"] >= 0) & (slots["row"] < rows)).all()
    # each (segment, step, lane) owns the 12 columns from first + 12 lane that lie in
    # the row: sorted by (row, start), the owned runs tile every row exactly once
    start = (slots["first"][:, None] + cols * np.arange(lanes)[None, :]).ravel()
    row = np.repeat(slots["row"], lanes)
    into = np.repeat(slots["into"], lanes)
    keep = start < T
    start, row, into = start[keep], row[keep], into[keep]
    end = np.minimum(start + cols, T)
    by = np.lexsort((start, row))
    start, row, into, end = start[by], row[by], into[by], end[by]
    first_of_row = np.r_[True, row[1:] != row[:-1]]
    assert np.array_equal(row[first_of_row], np.arange(rows))
    assert (start[first_of_row] == 0).all()
    assert (start[~first_of_row] == end[np.flatnonzero(~first_of_row) - 1]).all()
    assert (end[np.r_[first_of_row[1:], True]] == T).all()
    written = np.bincount(slots["partial"], minlength=plan["partials"])
    assert written.shape == (plan["partials"],) and (written == 1).all()
    order = _sum_order(plan)
    assert order.shape == (C, B * plan["pieces"])
    assert np.array_equal(np.sort(order.ravel()), np.arange(plan["partials"]))
    assert ((order // plan["pieces"]) % C == np.arange(C)[:, None]).all()
    # each slot's terms go to its own row's partials
    assert (slots["into"] // plan["pieces"] == slots["row"]).all()
    # a value w[r] per column of row r, summed through the partials
    w = np.random.default_rng(T).standard_normal(rows)
    partial = np.zeros(plan["partials"])
    np.add.at(partial, into, (end - start) * w[row])
    got = partial[order].sum(axis=1)
    want = T * w.reshape(B, C).sum(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_backward_plan_fills_the_card():
    """On 132 SMs holding 8 blocks each, the six stage shapes: rows of 96
    columns run four to a warp (8-lane segments); every grid is one wave
    of resident segments, with the fewest steps a segment that allow it,
    so long rows take several steps a segment."""
    for B, C, T in SPLIT_SHAPES[:6]:
        p = anti_alias.backward_plan(B, C, T, True, 8, 132, layout=LAYOUT)
        per_block = LAYOUT[1] // p["seg_lanes"]
        cap = 132 * 8 * per_block
        assert p["segments"] <= cap and p["blocks"] <= 132 * 8
        if p["steps"] > 1:
            fewer = anti_alias.backward_plan(B, C, T, True, 8, 132, steps=p["steps"] - 1,
                                             layout=LAYOUT)
            assert fewer["segments"] > cap
        assert p["multi_row"] == (T <= 384)
        assert p["seg_lanes"] == (8 if T == 96 else 32)
    assert anti_alias.backward_plan(8, 24, 24576, True, 8, 132, layout=LAYOUT)["steps"] > 1
