"""PyTorch port, DVAE mel tokenizer (models/dvae.py): `encode` and the codes,
`get_codebook_indices`, `decode`, `forward_loss`, `ema_update`,
`rebalance_codes` (fed JAX's normal draw), `discretization_loss`, the
uncentered spectrogram of the batched extractor, the TF32 guard, and
dvae.pth in both directions, each held against the JAX package on the same
numpy-seeded weights.  The config of tests/test_dvae.py (10 channels, 32
codes, hidden 16, codebook dim 24, 3 residual blocks), fp32, on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu.config import VQVAEConfig as JaxVQVAEConfig
from indextts_tpu.io import checkpoint as jax_ckpt
from indextts_tpu.io import export as jax_export
from indextts_tpu.models import dvae as jax_dvae
from indextts_tpu.ops import mel as jax_mel
from indextts_tpu_torch.config import VQVAEConfig
from indextts_tpu_torch.io import checkpoint, export, from_jax
from indextts_tpu_torch.models import dvae
from indextts_tpu_torch.ops import mel

SIZES = dict(channels=10, num_tokens=32, hidden_dim=16, codebook_dim=24, num_resnet_blocks=3)
CFG, JCFG = VQVAEConfig(**SIZES), JaxVQVAEConfig(**SIZES)
TOL = 1e-5


def dvae_numpy_params(jcfg, seed):
    """The JAX package's DVAE layout filled from numpy: conv weights at
    1/sqrt(fan_in), biases at 0.1, a normal codebook with positive cluster
    sizes and embed_avg = embed x cluster size."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jax_dvae.init_params(jax.random.PRNGKey(0), jcfg))

    def fill(path, leaf):
        if jax.tree_util.keystr(path).endswith("['b']"):
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan = int(np.prod(leaf.shape[-2:]))     # [.., out, in, k]: in x k
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(
        fill, {k: v for k, v in shapes.items() if k != "codebook"})
    embed = rng.standard_normal((jcfg.codebook_dim, jcfg.num_tokens)).astype(np.float32)
    size = rng.uniform(0.5, 2.0, jcfg.num_tokens).astype(np.float32)
    tree["codebook"] = {"embed": embed, "cluster_size": size, "embed_avg": embed * size}
    return tree


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_close(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max |diff| {err:.3g} > {rel} x {scale:.3g}"


@pytest.fixture(scope="module")
def setup():
    tree = dvae_numpy_params(JCFG, 0)
    mel_in = np.random.default_rng(1).standard_normal((2, 10, 64)).astype(np.float32)
    return dict(np=tree, jp=jax.tree.map(jnp.asarray, tree),
                tp=from_jax.dvae_params_from_numpy(tree, CFG), mel=mel_in)


def test_encode_and_codes_match_jax(setup):
    z_ref = jax_dvae.encode(setup["jp"], jnp.asarray(setup["mel"]), JCFG)
    z = dvae.encode(setup["tp"], torch.from_numpy(setup["mel"]), CFG)
    assert_close(z, z_ref, TOL, "z")
    codes_ref = np.asarray(jax_dvae.quantize_indices(setup["jp"]["codebook"], z_ref))
    codes = dvae.quantize_indices(setup["tp"]["codebook"], z)
    assert codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), codes_ref)
    # the extraction entry point, at the default config's kernel and stride
    got = dvae.get_codebook_indices(setup["tp"], torch.from_numpy(setup["mel"]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_dvae.get_codebook_indices(setup["jp"],
                                                              jnp.asarray(setup["mel"]))))
    assert len(set(codes_ref.reshape(-1).tolist())) > 4      # not a degenerate check


def test_quantize_ties_go_to_the_first_index():
    embed = torch.tensor([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0]])
    z = torch.tensor([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
    codes = dvae.quantize_indices({"embed": embed}, z)
    ref = jax_dvae.quantize_indices({"embed": jnp.asarray(embed.numpy())}, jnp.asarray(z.numpy()))
    assert codes.tolist() == np.asarray(ref).tolist() == [0, 1, 0]


def test_decode_matches_jax(setup):
    codes = np.random.default_rng(2).integers(0, 32, (2, 16)).astype(np.int32)
    ref = jax_dvae.decode(setup["jp"], jnp.asarray(codes), JCFG)
    got = dvae.decode(setup["tp"], torch.from_numpy(codes), CFG)
    assert tuple(got.shape) == (2, 10, 64)
    assert_close(got, ref, TOL, "decode")


@pytest.mark.parametrize("smooth_l1", [True, False])
def test_forward_loss_matches_jax(setup, smooth_l1):
    import dataclasses

    jcfg = dataclasses.replace(JCFG, smooth_l1_loss=smooth_l1)
    cfg = dataclasses.replace(CFG, smooth_l1_loss=smooth_l1)
    ref = jax_dvae.forward_loss(setup["jp"], jnp.asarray(setup["mel"]), jcfg)
    got = dvae.forward_loss(setup["tp"], torch.from_numpy(setup["mel"]), cfg)
    for k in ("recon_loss", "commitment_loss"):
        assert_close(got[k], ref[k], TOL, k)
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(ref["codes"]))


def test_ema_update_matches_jax(setup):
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 16, 24)).astype(np.float32)
    codes = rng.integers(0, 32, (2, 16)).astype(np.int32)
    ref = jax_dvae.ema_update(setup["jp"]["codebook"], jnp.asarray(z), jnp.asarray(codes),
                              decay=0.9)
    got = dvae.ema_update(setup["tp"]["codebook"], torch.from_numpy(z),
                          torch.from_numpy(codes), decay=0.9)
    for k in ("embed", "cluster_size", "embed_avg"):
        assert_close(got[k], ref[k], 1e-6, k)


def test_rebalance_matches_jax_with_its_draw(setup):
    usage = np.full(32, 0.5 / 30, np.float32)
    usage[[3, 9]] = [0.95, 0.001]            # one dominant, one dead code
    usage[[11, 20]] = 0.0
    key = jax.random.PRNGKey(7)
    cb_ref, n_ref = jax_dvae.rebalance_codes(setup["jp"]["codebook"], jnp.asarray(usage), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (24, 32), jnp.float32)))
    cb, n = dvae.rebalance_codes(setup["tp"]["codebook"], torch.from_numpy(usage), noise=noise)
    assert int(n) == int(n_ref) == 4 and n.dtype == torch.int32
    mask = np.asarray(cb_ref["cluster_size"]) == 0
    np.testing.assert_array_equal(cb["cluster_size"].numpy() == 0, mask)
    for k in ("embed", "cluster_size", "embed_avg"):
        assert_close(cb[k], cb_ref[k], 1e-6, k)
    # without a draw the port takes one from its generator
    cb2, _ = dvae.rebalance_codes(setup["tp"]["codebook"], torch.from_numpy(usage),
                                  generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(cb2["embed"]).all() and not torch.equal(cb2["embed"], cb["embed"])


@pytest.mark.parametrize("past", [False, True])
def test_discretization_loss_matches_jax(past):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 5, 32)).astype(np.float32)
    kw, tkw = {}, {}
    if past:
        pm = (0.01 * rng.standard_normal(32)).astype(np.float32)
        kw = dict(past_mean=jnp.asarray(pm), past_count=3)
        tkw = dict(past_mean=torch.from_numpy(pm), past_count=3)
    ref = jax_dvae.discretization_loss(jnp.asarray(x), 2, 1.0 / 32, **kw)
    got = dvae.discretization_loss(torch.from_numpy(x), 2, 1.0 / 32, **tkw)
    assert_close(got, ref, 1e-6, "discretization_loss")


@pytest.mark.parametrize("center", [False, True])
def test_spectrogram_matches_jax(center):
    rng = np.random.default_rng(5)
    wav = (0.1 * rng.standard_normal((2, 6000))).astype(np.float32)
    if not center:   # the extractor's host-side reflect pad
        wav = np.pad(wav, ((0, 0), (512, 512)), mode="reflect")
    ref = jax_mel.spectrogram(jnp.asarray(wav), 1024, 256, 1024, power=1.0, center=center)
    got = mel.spectrogram(torch.from_numpy(wav), 1024, 256, 1024, power=1.0, center=center)
    assert_close(got, ref, TOL, "spectrogram")


def test_no_tf32_restores_the_flags():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            with dvae.no_tf32():
                assert not torch.backends.cudnn.allow_tf32
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.backends.cudnn.allow_tf32 is flag
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_dvae_pth_crosses_bit_equal(setup, tmp_path, direction):
    path = str(tmp_path / "dvae.pth")
    if direction == "jax_to_port":
        jax_export.save_dvae_pth(path, setup["np"], JCFG)
        tree = checkpoint.load_dvae_checkpoint(path, CFG)
    else:
        export.save_dvae_pth(path, setup["tp"], CFG)
        tree = jax_ckpt.load_dvae_checkpoint(path, JCFG)
    want = jax.tree.leaves_with_path(setup["np"])
    got = dict(jax.tree.leaves_with_path(tree))
    assert len(got) == len(want)
    for path_, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path_]), leaf,
                                      err_msg=jax.tree_util.keystr(path_))
    # and the port's loader takes it to its tree
    from_jax.dvae_params_from_numpy(tree, CFG)
