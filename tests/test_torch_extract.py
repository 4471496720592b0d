"""PyTorch port, codec extraction (data/extract.py) against the JAX
package's on the same audio and the same gpt.pth and dvae.pth (written by
JAX's exporters from one numpy tree), batched and clip by clip: manifests
and speaker_info.json byte-equal, mels within 1e-4, codes equal wherever
JAX's two nearest codebook columns are more than 1e-4 apart (at most 1% of
positions exempt), the medoid conditioning within 1e-4; within the port,
batched against clip by clip; the port's LoRA Trainer on the port's
output; condition_type "conformer_encoder" (refused before); and the
device rule.  The TINY config of tests/test_extract.py, 2 speakers x 3
clips of at most 2 s (one frame bucket), fp32, on the CPU."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from indextts_tpu import config as jax_config
from indextts_tpu.data import extract as jax_extract
from indextts_tpu.io import export as jax_export
from indextts_tpu.models import dvae as jax_dvae
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.ops import mel as jax_mel
from indextts_tpu_torch.config import Config
from indextts_tpu_torch.data import extract
from indextts_tpu_torch.train.run import Trainer
from indextts_tpu_torch.utils.audio import load_prompt_audio, write_wav
from tests.test_extract import TINY as JAX_TINY
from tests.test_torch_dvae import dvae_numpy_params
from tests.test_torch_gpt import numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {
    "gpt": {"model_dim": 64, "layers": 2, "heads": 4,
            "condition_module": {"output_size": 32, "linear_units": 64, "attention_heads": 4,
                                 "num_blocks": 2, "perceiver_mult": 2}},
    "vqvae": {"channels": 100, "num_tokens": 64, "hidden_dim": 16, "codebook_dim": 24,
              "num_resnet_blocks": 2},
}
SECONDS = (1.0, 1.55, 2.0)
MARGIN = 1e-4


def _write_clips(root, rng):
    lines = []
    for s, spk in enumerate(("spk_a", "spk_b")):
        d = root / spk
        d.mkdir()
        for i, sec in enumerate(SECONDS):
            t = np.arange(int(sec * 24000)) / 24000
            f0 = 110.0 * (1 + s + i)
            x = 0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.2 * t)) + 0.05 * rng.standard_normal(t.size)
            write_wav(str(d / f"clip{i}.wav"), (x * 32767).astype(np.int16), 24000)
            lines.append(f"{d / f'clip{i}.wav'}\t第{i}句測試文本，說話人{spk}。")
    path = root / "list.txt"
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    assert JAX_TINY.vqvae.num_tokens == SPEC["vqvae"]["num_tokens"]
    jcfg, cfg = jax_config.Config.from_dict(SPEC), Config.from_dict(SPEC)
    model_dir = root / "model"
    model_dir.mkdir()
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), model_dir / "vocab.txt")
    gpt_np = numpy_params(jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0),
                                                                    jcfg.gpt)),
                          1, lambda s: 1.0 / np.sqrt(s[-2]))
    dvae_np = dvae_numpy_params(jcfg.vqvae, 2)
    jax_export.save_gpt_pth(str(model_dir / "gpt.pth"), gpt_np, jcfg.gpt, save_dtype="fp32")
    jax_export.save_dvae_pth(str(model_dir / "dvae.pth"), dvae_np, jcfg.vqvae)
    list_path = _write_clips(root, np.random.default_rng(0))
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for exact in (False, True):
            key = "exact" if exact else "batched"
            out["jax", key] = str(root / f"jax_{key}")
            jax_extract.extract_audio_list(list_path, out["jax", key], jcfg, str(model_dir),
                                           valid_ratio=0.34, num_workers=2, exact=exact)
            out["port", key] = str(root / f"port_{key}")
            extract.extract_audio_list(list_path, out["port", key], cfg, str(model_dir),
                                       valid_ratio=0.34, num_workers=2, exact=exact,
                                       device="cpu")
    return dict(root=root, jcfg=jcfg, cfg=cfg, model_dir=str(model_dir), list=list_path,
                out=out, dvae=jax.tree.map(jnp.asarray, dvae_np))


def _files(d, suffix):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d)
                  for f in fs if f.endswith(suffix))


def _jax_margins(ws, wav, batched):
    """JAX's (second-best - best) / best distance at each of the clip's code
    positions, over the mel the DVAE saw: the bucket-wide row of the
    batched path, or the clip's own trimmed mel."""
    m = ws["jcfg"].dataset.mel
    F = extract.frames_for(wav.shape[-1], m.hop_length)
    if batched:
        Lw = (extract.bucket_frames(F) - 1) * m.hop_length + m.n_fft
        row = np.zeros((1, Lw), np.float32)
        padded = np.pad(wav, (m.n_fft // 2, m.n_fft // 2), mode="reflect")[:Lw]
        row[0, : padded.size] = padded
        spec = jax_mel.spectrogram(jnp.asarray(row), m.n_fft, m.hop_length, m.win_length,
                                   power=1.0, center=False)
        fb = jnp.asarray(jax_mel.mel_filterbank(m.sample_rate, m.n_fft, m.n_mels))
        mel = jax_mel.safe_log(jnp.einsum("...ft,fm->...mt", spec, fb))
    else:
        mel = jax_mel.mel_spectrogram(jnp.asarray(wav[None]))
        mel = mel[..., : mel.shape[-1] - mel.shape[-1] % 4]
    z = jax_dvae.encode(ws["dvae"], mel, ws["jcfg"].vqvae)[0]
    e = ws["dvae"]["codebook"]["embed"]
    dist = np.asarray(jnp.sum(z * z, -1, keepdims=True) - 2.0 * z @ e
                      + jnp.sum(e * e, 0)[None])
    two = np.sort(dist, axis=-1)[:, :2]
    n = (F - F % 4) // 4
    return ((two[:, 1] - two[:, 0]) / np.abs(two[:, 0]))[:n]


@pytest.mark.parametrize("mode", ["batched", "exact"])
def test_port_extraction_matches_jax(ws, mode):
    jd, td = ws["out"]["jax", mode], ws["out"]["port", mode]
    # text files byte for byte
    texts = _files(jd, ".jsonl") + ["speaker_info.json"]
    assert texts == _files(td, ".jsonl") + ["speaker_info.json"] and len(texts) == 5
    for rel in texts:
        with open(os.path.join(jd, rel), "rb") as a, open(os.path.join(td, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert _files(jd, ".npy") == _files(td, ".npy")
    # mels and the medoid conditioning
    for rel in _files(jd, ".npy"):
        ref, got = np.load(os.path.join(jd, rel)), np.load(os.path.join(td, rel))
        assert got.dtype == ref.dtype and got.shape == ref.shape, rel
        if "/mels/" in rel or rel.endswith("medoid_mel.npy"):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=rel)
        elif rel.endswith("medoid_condition.npy"):
            assert got.shape == (1, 32, 64)
            assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), rel
    # codes: equal wherever JAX's nearest two columns are clearly apart
    wavs = {p: np.asarray(load_prompt_audio(p, 24000), np.float32).reshape(-1)
            for p, _ in extract.parse_audio_list(ws["list"])}
    total = exempt = 0
    distinct = set()
    for p, wav in wavs.items():
        rel = os.path.join(extract.speaker_of(p), "codes",
                           os.path.splitext(os.path.basename(p))[0] + ".npy")
        ref, got = np.load(os.path.join(jd, rel)), np.load(os.path.join(td, rel))
        assert got.dtype == ref.dtype == np.int32 and got.shape == ref.shape, rel
        clear = _jax_margins(ws, wav, mode == "batched") > MARGIN
        assert clear.shape == ref.shape
        np.testing.assert_array_equal(got[clear], ref[clear], err_msg=rel)
        total, exempt = total + ref.size, exempt + int((~clear).sum())
        distinct |= set(ref.tolist())
    assert total > 200 and exempt <= 0.01 * total, (exempt, total)
    assert len(distinct) > 4                   # not one code everywhere


def test_batched_against_clip_by_clip_within_the_port(ws):
    """JAX's own bound (tests/test_extract.py): mels equal, codes equal but
    for a tail window of 8, conditioning close."""
    ex = extract.CodecExtractor(ws["cfg"], ws["model_dir"], batch_size=4, device="cpu")
    wavs = [np.asarray(load_prompt_audio(p, 24000), np.float32).reshape(-1)
            for p, _ in extract.parse_audio_list(ws["list"])[:3]]
    for w, feat in zip(wavs, ex.extract_batch(wavs, extract_condition=True)):
        mel_ref, codes_ref = ex.extract_clip_features(w[None])
        np.testing.assert_allclose(feat["mel"], mel_ref, rtol=1e-4, atol=1e-4)
        n = codes_ref.shape[0]
        assert feat["codes"].shape[0] == n
        np.testing.assert_array_equal(feat["codes"][: n - 8], codes_ref[: n - 8])
        np.testing.assert_allclose(feat["cond"], ex.conditioning_latent(mel_ref),
                                   rtol=5e-3, atol=5e-3)


def test_trainer_runs_on_the_extracted_codes(ws):
    train = {"finetune_model_dir": str(ws["root"] / "ft"), "data_path": ws["out"]["port",
                                                                                "batched"],
             "epochs": 1, "batch_size": 2, "valid_batch_size": 2, "max_steps_per_epoch": 2,
             "gradient_accumulation_steps": 1, "mixed_precision": "fp32", "save_dtype": "fp32"}
    cfg = Config.from_dict({**SPEC, "train": train})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = Trainer(cfg, ws["model_dir"], run_name="extracted", device="cpu")
        t.train()
    assert int(t.state.step) == 2
    assert np.isfinite(t.best_val)
    assert os.path.exists(os.path.join(t.out_dir, "gpt_finetuned.pth"))


def test_conformer_encoder_extracts_as_conformer_perceiver(ws, tmp_path):
    """The JAX package runs "conformer_encoder" on the conformer -> perceiver
    path; the port refused it.  Its extraction now equals the
    conformer_perceiver extraction's, file for file."""
    cfg = Config.from_dict({**SPEC, "gpt": {**SPEC["gpt"], "condition_type":
                                            "conformer_encoder"}})
    out = str(tmp_path / "enc")
    extract.extract_audio_list(ws["list"], out, cfg, ws["model_dir"], valid_ratio=0.34,
                               num_workers=2, device="cpu")
    ref = ws["out"]["port", "batched"]
    assert _files(out, ".npy") == _files(ref, ".npy")
    for rel in _files(ref, ".npy") + ["speaker_info.json"]:
        with open(os.path.join(out, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_extraction_defaults_to_cuda_and_raises_without_it(ws):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        extract.CodecExtractor(ws["cfg"], ws["model_dir"])
