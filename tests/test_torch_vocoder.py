"""PyTorch port, vocoder: ECAPA speaker embedding and BigVGAN waveform held
against the JAX package on the same weights (carried over by io/from_jax)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import ecapa as jax_ecapa
from indextts_tpu_torch.config import BigVGANConfig
from indextts_tpu_torch.io import from_jax
from indextts_tpu_torch.models import bigvgan, ecapa
from tests.test_torch_gpt import numpy_params

# the tiny vocoder of tests/test_engine.py: 64 initial channels
TINY = dict(upsample_rates=[4, 4, 4, 4, 2, 2], upsample_kernel_sizes=[8, 8, 4, 4, 4, 4],
            upsample_initial_channel=64, resblock_kernel_sizes=[3],
            resblock_dilation_sizes=[[1, 3]], speaker_embedding_dim=8, gpt_dim=64)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config.BigVGANConfig(**TINY)
    shapes = jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(0), jcfg))
    # conv weights [C_out, C_in, K] (transposed: [C_in, C_out, K]) scaled by fan-in
    np_params = numpy_params(shapes, 3, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    tparams = from_jax.bigvgan_params_from_numpy(np_params, BigVGANConfig(**TINY))
    rng = np.random.default_rng(0)
    latent = rng.standard_normal((1, 7, 64)).astype(np.float32)
    mel = rng.standard_normal((1, 45, 100)).astype(np.float32)
    return jcfg, np_params, tparams, latent, mel


def test_ecapa_matches_jax(setup):
    _, np_params, tparams, _, mel = setup
    size = jax_ecapa.ECAPASize(input_size=100, lin_neurons=8)
    jp = jax.tree.map(jnp.asarray, np_params["speaker_encoder"])
    ref = np.asarray(jax_ecapa.forward(jp, jnp.asarray(mel), size))
    got = ecapa.forward(tparams["speaker_encoder"], torch.from_numpy(mel),
                        ecapa.ECAPASize(input_size=100, lin_neurons=8)).numpy()
    assert got.shape == ref.shape == (1, 1, 8)
    # fp32 convolutions through 1536 channels and a softmax pooling
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_bigvgan_waveform_matches_jax(setup):
    jcfg, np_params, tparams, latent, mel = setup
    jp = jax.tree.map(jnp.asarray, np_params)
    ref = np.asarray(jax_bigvgan.forward(jp, jnp.asarray(latent), jnp.asarray(mel), jcfg))
    got = bigvgan.forward(tparams, torch.from_numpy(latent), torch.from_numpy(mel),
                          BigVGANConfig(**TINY)).numpy()
    assert got.shape == ref.shape == (1, 1, 7 * 1024)
    # fp32 on both sides; waveform in [-1, 1], one int16 step is 3e-5
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_from_numpy_rejects_a_wrong_tree(setup):
    _, np_params, _, _, _ = setup
    bad = dict(np_params)
    bad["conv_post"] = {"w": np.zeros((1, 2, 7), np.float32), "b": np.zeros(1, np.float32)}
    with pytest.raises(ValueError, match="conv_post.w"):
        from_jax.bigvgan_params_from_numpy(bad, BigVGANConfig(**TINY))


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_every_activation_goes_through_the_kernel_wrapper(setup, monkeypatch,
                                                          use_fused_kernel):
    """A config that sets the reference's `use_fused_kernel` key still loads
    and opens no second route to the plain version: each of the 6 stages x
    2 convs x 2 dilations, plus activation_post, calls the K1 wrapper (which
    picks the plain version only for CPU tensors)."""
    from indextts_tpu_torch.config import Config
    from indextts_tpu_torch.ops.cuda import anti_alias

    _, _, tparams, latent, mel = setup
    calls = []
    wrapper = anti_alias.fused_anti_alias_activation
    monkeypatch.setattr(anti_alias, "fused_anti_alias_activation",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    cfg = Config.from_dict({"bigvgan": {**TINY, "use_fused_kernel": use_fused_kernel}}).bigvgan
    assert cfg == BigVGANConfig(**TINY)
    bigvgan.forward(tparams, torch.from_numpy(latent), torch.from_numpy(mel), cfg)
    assert len(calls) == 6 * 2 * 2 + 1
    assert wrapper.launches == 0  # CPU tensors: the plain version, no launch
