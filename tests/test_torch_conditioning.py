"""PyTorch port, conditioning: conformer -> perceiver latents
(`get_conditioning`) held against the JAX package on the same weights."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu_torch.config import GPTConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import unified_voice as uv
from tests.test_torch_gpt import TINY, gpt_numpy_params

@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.GPTConfig.from_dict(TINY)
    np_params = gpt_numpy_params(jcfg)
    tcfg = GPTConfig.from_dict(TINY)
    return jcfg, tcfg, np_params, from_jax.gpt_params_from_numpy(np_params, tcfg)


@pytest.mark.parametrize("lengths", [[40], [40, 27]])
def test_get_conditioning_matches_jax(setup, lengths):
    """Two rows of different lengths exercise the conformer's pad mask."""
    jcfg, tcfg, np_params, tparams = setup
    mel = np.random.default_rng(len(lengths)).standard_normal(
        (len(lengths), 100, 40)).astype(np.float32)
    ref = np.asarray(jax_uv.get_conditioning(
        jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(mel),
        jnp.asarray(lengths)))
    got = uv.get_conditioning(tparams, tcfg, torch.from_numpy(mel),
                              torch.tensor(lengths)).numpy()
    assert got.shape == ref.shape == (len(lengths), 32, 64)
    # fp32 through 2 conformer blocks and 2 perceiver blocks; the RMSNorm
    # output has unit RMS
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_legacy_condition_types_raise(setup):
    """The legacy condition types raised NotImplementedError until the port
    had their encoders; now they initialise in JAX's layout and condition
    ([B, 32, D] for "perceiver", [B, 1, D] mean-pooled), as in JAX.  Their
    values against JAX's are tests/test_torch_legacy_conditioning.py's."""
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 100, 40))
                           .astype(np.float32))
    for ctype, latents in (("perceiver", 32), ("default_mean", 1)):
        cfg = GPTConfig.from_dict({**TINY, "condition_type": ctype})
        jcfg = jax_config.GPTConfig.from_dict({**TINY, "condition_type": ctype})
        params = uv.init_params(cfg, torch.Generator().manual_seed(0))
        shapes = jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg))
        assert jax.tree.map(lambda x: tuple(x.shape), params) == \
            jax.tree.map(lambda x: tuple(x.shape), shapes)
        out = uv.get_conditioning(params, cfg, mel, torch.tensor([40, 40]))
        assert tuple(out.shape) == (2, latents, 64) and torch.isfinite(out).all()
