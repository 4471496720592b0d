"""PyTorch port, anti-aliased SnakeBeta: the plain version of the CUDA kernel
(ops/filters.py) against the JAX composition and the TPU kernel run in
interpret mode; on CPU tensors the wrapper takes the plain version and
launches nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from indextts_tpu.ops import filters as jax_filters
from indextts_tpu.ops.pallas import anti_alias as jax_anti_alias
from indextts_tpu_torch.ops import filters
from indextts_tpu_torch.ops.cuda import anti_alias

# fp32 on both sides; the two libraries order the 12-tap sums differently
TOL = 2e-5


def _inputs(B, C, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, C, T)).astype(np.float32)
    alpha = (0.3 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(C)).astype(np.float32)
    return x, alpha, beta


# The CUDA kernel's split points (chip_smoke.py holds the kernel against the
# plain version at the same shapes): a thread owns 24 outputs, a block step
# 1536; B > 1 with an odd T takes its scalar path; T < 7 clamps both edges.
SPLITS = [(1, 4, 23), (1, 4, 24), (1, 4, 25), (1, 2, 1535), (1, 2, 1536), (1, 2, 1537),
          (3, 4, 1003), (1, 3, 2), (2, 3, 3), (2, 3, 9), (2, 3, 17)]


@pytest.mark.parametrize("B,C,T", [(1, 3, 1), (2, 4, 5), (1, 8, 7), (1, 5, 15),
                                   (1, 8, 16), (2, 6, 101)] + SPLITS)
def test_plain_matches_jax_composition(B, C, T):
    x, a, b = _inputs(B, C, T, T)
    ref = np.asarray(jax_filters.anti_aliased_activation(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b)))
    got = filters.anti_aliased_activation(torch.from_numpy(x), torch.from_numpy(a),
                                          torch.from_numpy(b)).numpy()
    assert got.shape == (B, C, T)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("C,T", [(8, 40), (128, 600), (16, 256)]
                         + [(C, T) for B, C, T in SPLITS if B == 1])
def test_wrapper_on_cpu_matches_tpu_kernel_interpret(C, T):
    """(128, 600) runs three tiles with a ragged last one; (8, 40) one ragged."""
    _wrapper_against_interpret(1, C, T)


@pytest.mark.parametrize("B,C,T", [(B, C, T) for B, C, T in SPLITS if B > 1])
def test_wrapper_on_cpu_matches_tpu_kernel_interpret_batched(B, C, T):
    _wrapper_against_interpret(B, C, T)


def _wrapper_against_interpret(B, C, T):
    x, a, b = _inputs(B, C, T, C + T)
    ref = np.asarray(jax_anti_alias.fused_anti_alias_activation(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), force_pallas=True, mxu=False))
    before = anti_alias.fused_anti_alias_activation.launches
    got = anti_alias.fused_anti_alias_activation(
        torch.from_numpy(x), torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert anti_alias.fused_anti_alias_activation.launches == before == 0
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_resampling_pieces_match_jax():
    x, a, b = _inputs(1, 4, 33, 7)
    xt = torch.from_numpy(x)
    up = filters.upsample2x(xt)
    np.testing.assert_allclose(up.numpy(), np.asarray(jax_filters.upsample2x(jnp.asarray(x))),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        filters.downsample2x(up).numpy(),
        np.asarray(jax_filters.downsample2x(jnp.asarray(up.numpy()))), atol=TOL, rtol=0)
    np.testing.assert_allclose(
        filters.snake_beta(xt, torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_filters.snake_beta(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6, rtol=0)


def test_plain_version_keeps_bf16_type_and_fp32_math():
    x, a, b = _inputs(1, 4, 50, 9)
    xb = torch.from_numpy(x).bfloat16()
    got = filters.anti_aliased_activation(xb, torch.from_numpy(a), torch.from_numpy(b))
    ref = filters.anti_aliased_activation(xb.float(), torch.from_numpy(a),
                                          torch.from_numpy(b)).bfloat16()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)
