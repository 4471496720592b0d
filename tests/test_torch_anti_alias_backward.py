"""PyTorch port, the backward of the anti-aliased SnakeBeta (K1b's plain
version, ops/filters.anti_aliased_activation_backward) against jax.vjp of
the JAX package's XLA composition and against torch autograd of the plain
forward (and gradcheck in fp64); the autograd function of
ops/cuda/anti_alias.py (K1 forward, K1b backward), with its launchers
counted, at the op and through a tiny BigVGAN."""

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
