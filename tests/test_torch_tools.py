"""PyTorch port, the tools (indextts_tpu_torch/tools/, verify.py,
utils/profiling.py), on the CPU at tiny sizes: `export_pth` from the port's
checkpoint directories to .pth files that JAX's loaders read back equal to
the trees; the verification gate's dry run (the 11-case battery) and its
records against JAX's `run_battery` on one stub engine; the profiling
helpers; each bench tool's JSON line; the entry; and the device rule."""

import json
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax

from indextts_tpu import verify as jax_verify
from indextts_tpu.config import Config as JaxConfig
from indextts_tpu.io import checkpoint as jax_ckpt
from indextts_tpu.models import bigvgan as jax_bigvgan
from indextts_tpu.models import unified_voice as jax_uv
from indextts_tpu.utils import eval_metrics as jax_eval_metrics
from indextts_tpu_torch import verify
from indextts_tpu_torch.config import Config
from indextts_tpu_torch.io import checkpoint, from_jax
from indextts_tpu_torch.tools import (_common, bench, bench_beam_pool, bench_beam_step,
                                      bench_e2e, bench_pool, bench_pool_trunk, entry,
                                      eval_quality, export_pth, verify_weights)
from indextts_tpu_torch.utils import eval_metrics, profiling
from tests.test_torch_checkpoint import _leaves
from tests.test_torch_dvae import JCFG as DVAE_JCFG, SIZES as DVAE_SIZES, dvae_numpy_params
from tests.test_torch_engine import MODEL, REPO
from tests.test_torch_gpt import numpy_params


@pytest.fixture(scope="module")
def trees():
    """The tiny config in both packages (with the DVAE of test_torch_dvae)
    and one numpy-seeded float tree per model, as test_torch_checkpoint
    builds them."""
    model = {**MODEL, "vqvae": DVAE_SIZES}
    jcfg, tcfg = JaxConfig.from_dict(model), Config.from_dict(model)
    gpt_np = numpy_params(
        jax.eval_shape(lambda: jax_uv.init_params(jax.random.PRNGKey(0), jcfg.gpt)), 1,
        lambda s: 1.0 / np.sqrt(s[-2]))
    bv_np = numpy_params(
        jax.eval_shape(lambda: jax_bigvgan.init_params(jax.random.PRNGKey(1), jcfg.bigvgan)),
        2, lambda s: 0.5 / np.sqrt(s[-2] * s[-1]))
    return jcfg, tcfg, gpt_np, bv_np, dvae_numpy_params(DVAE_JCFG, 0)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A model directory with the tiny config and the repository's vocab,
    no weights (the tools draw random ones), and a prompt wav."""
    from scipy.io import wavfile

    d = tmp_path_factory.mktemp("tools_model")
    Config.from_dict(_common.TINY_MODEL).save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    sr = 24000
    t = np.arange(sr) / sr
    wavfile.write(str(d / "prompt.wav"), sr, (0.3 * np.sin(2 * np.pi * 220 * t)
                                             * 32767).astype(np.int16))
    return d


# -- export_pth -----------------------------------------------------------

def _speaker_data(root, D):
    rng = np.random.default_rng(5)
    for sp in ("spk_b", "spk_a"):
        os.makedirs(root / sp)
        np.save(root / sp / "medoid_condition.npy",
                rng.standard_normal((1, 32, D)).astype(np.float32))
        np.save(root / sp / "medoid_mel.npy", rng.standard_normal((100, 40)).astype(np.float32))
    with open(root / "speaker_info.json", "w", encoding="utf-8") as f:
        json.dump([{"speaker": "spk_b"}, {"speaker": "spk_a"}], f)


@pytest.mark.parametrize("kind", ["gpt", "dvae", "vocoder"])
def test_export_pth_reads_back_in_jax(trees, kind, tmp_path):
    """A directory the port's save_pytree wrote, in each trainer's layout
    (model_epoch_N: the merged tree in bf16; dvae_step_N and vocoder_step_N:
    the state dicts), becomes a .pth that JAX's loaders read back equal to
    the tree: bit for bit, and within two fp32 ulps for the vocoder, whose
    weight-norm fold rounds; the GPT with the speakers of --data-path."""
    jcfg, tcfg, gpt_np, bv_np, dvae_np = trees
    cfg_path = str(tmp_path / "config.yaml")
    tcfg.save(cfg_path)
    ckpt, out = str(tmp_path / f"{kind}_ckpt"), str(tmp_path / f"{kind}.pth")
    args = [kind, "--ckpt", ckpt, "--config", cfg_path, "--out", out, "--device", "cpu"]
    if kind == "gpt":
        tree = from_jax.gpt_params_from_numpy(gpt_np, tcfg.gpt, torch.bfloat16)
        checkpoint.save_pytree(ckpt, tree)
        _speaker_data(tmp_path / "data", tcfg.gpt.model_dim)
        export_pth.main(args + ["--dtype", "bf16", "--data-path", str(tmp_path / "data")])
        got, extras = jax_ckpt.load_gpt_checkpoint(out, jcfg.gpt)
        want = tree
        assert extras["speakers"] == ["spk_a", "spk_b"]
        for sp in ("spk_a", "spk_b"):
            np.testing.assert_array_equal(
                extras["speaker_conditions"][sp],
                np.load(tmp_path / "data" / sp / "medoid_condition.npy"))
        sd = torch.load(out, weights_only=False)
        assert sd["model"]["gpt.h.0.attn.c_attn.weight"].dtype == torch.bfloat16
        assert sorted(sd["speaker_mels"]) == ["spk_a", "spk_b"]
    elif kind == "dvae":
        checkpoint.save_pytree(ckpt, {"params": from_jax.dvae_params_from_numpy(
            dvae_np, tcfg.vqvae), "step": 40})
        export_pth.main(args)
        got, want = jax_ckpt.load_dvae_checkpoint(out, jcfg.vqvae), dvae_np
        assert torch.load(out, weights_only=False)["codebook.embed"].dtype == torch.float32
    else:
        checkpoint.save_pytree(ckpt, {
            "gen_params": from_jax.bigvgan_params_from_numpy(bv_np, tcfg.bigvgan),
            "disc_params": {"mpd": [{"period": 2, "convs": [torch.zeros(2, 1, 5, 1)]}]},
            "step": 3})
        export_pth.main(args)
        got, want = jax_ckpt.load_bigvgan_checkpoint(out, jcfg.bigvgan), bv_np
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    rtol = 2.4e-7 if kind == "vocoder" else 0
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=0, rtol=rtol, err_msg=k)


def test_export_pth_defaults_and_rounding(trees, tmp_path):
    """The JAX tool's defaults (fp16 for the GPT), --round-to (the weights
    rounded to bf16 before the fp32 file is written: the loader's fold lands
    on the bf16 values), and an orbax directory refused with the .pth
    route named."""
    jcfg, tcfg, gpt_np, bv_np, _ = trees
    cfg_path = str(tmp_path / "config.yaml")
    tcfg.save(cfg_path)
    ckpt = str(tmp_path / "model_epoch_0")
    checkpoint.save_pytree(ckpt, from_jax.gpt_params_from_numpy(gpt_np, tcfg.gpt))
    export_pth.main(["gpt", "--ckpt", ckpt, "--config", cfg_path, "--out",
                     str(tmp_path / "g.pth"), "--device", "cpu"])
    sd = torch.load(str(tmp_path / "g.pth"), weights_only=False)
    assert sd["model"]["gpt.h.0.attn.c_attn.weight"].dtype == torch.float16
    gen = from_jax.bigvgan_params_from_numpy(bv_np, tcfg.bigvgan)
    checkpoint.save_pytree(str(tmp_path / "vocoder_step_1"), {"gen_params": gen, "step": 1})
    export_pth.main(["vocoder", "--ckpt", str(tmp_path / "vocoder_step_1"), "--config", cfg_path,
                     "--out", str(tmp_path / "v.pth"), "--round-to", "bf16", "--device", "cpu"])
    sd = torch.load(str(tmp_path / "v.pth"), weights_only=False)["generator"]
    for k, v in sd.items():       # weight_g is a norm: the one value not rounded
        if v.is_floating_point() and not k.endswith("weight_g"):
            assert torch.equal(v, v.bfloat16().float()), k
    got = checkpoint.load_bigvgan_checkpoint(str(tmp_path / "v.pth"), tcfg.bigvgan)
    for (k, a), (_, b) in zip(_leaves(got), _leaves(bv_np)):
        want = torch.tensor(b).bfloat16().float().numpy()
        assert np.array_equal(torch.tensor(a).bfloat16().float().numpy(), want), k
    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        export_pth.main(["dvae", "--ckpt", str(orbax), "--out", str(tmp_path / "d.pth"),
                         "--device", "cpu"])


# -- the verification gate ------------------------------------------------

class _StubEngine:
    """Writes a fixed tone for every call, as an engine's infer would."""

    def __init__(self):
        self.last_stats = {}
        self.bigvgan_params = None

    def _write(self, prompt, text, out, **kw):
        from scipy.io import wavfile

        t = np.arange(4096 + 32 * len(text)) / 24000
        wavfile.write(out, 24000, (0.1 * np.sin(2 * np.pi * 300 * t) * 32767).astype(np.int16))
        self.last_stats = {"rtf": 0.25 + len(text) / 1e3}
        return out

    infer = infer_fast = _write


def test_battery_records_match_jax(model_dir, tmp_path, monkeypatch):
    """The same 11 cases, modes and records (apart from each package's own
    wav path and wall time) from both packages' run_battery on one stub
    engine, with the speaker metric stubbed alike."""
    monkeypatch.setattr(jax_eval_metrics, "speaker_similarity", lambda p, a, b: 0.5)
    monkeypatch.setattr(eval_metrics, "speaker_similarity", lambda p, a, b: 0.5)
    prompt = str(model_dir / "prompt.wav")
    assert verify.REGRESSION_BATTERY == jax_verify.REGRESSION_BATTERY
    want = jax_verify.run_battery(_StubEngine(), prompt, str(tmp_path / "jax"))
    got = verify.run_battery(_StubEngine(), prompt, str(tmp_path / "port"))
    assert len(got) == 11
    for g, w in zip(got, want):
        assert list(g) == list(w)
        strip = lambda r: {k: v for k, v in r.items() if k not in ("wav", "wall_s")}  # noqa: E731
        assert strip(g) == strip(w)


def test_dry_run_gate(model_dir, tmp_path):
    """--dry-run on the CPU at the tools' tiny size: exported synthetic
    checkpoints, the engine built from them, the whole 11-case battery, the
    quality report as one JSON line with JAX's report keys."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = verify_weights.main(["--dry-run", "--prompt", str(model_dir / "prompt.wav"),
                                      "--device", "cpu", "--max-mel-tokens", "2",
                                      "--report", str(tmp_path / "r.json")])
    assert report["battery_ok"] is True and report["dry_run"] is True
    assert report["checkpoints"]["missing"] == [] and report["device"] == "cpu"
    assert [r["mode"] for r in report["cases"]] == [m for _, m in verify.REGRESSION_BATTERY]
    for r in report["cases"]:
        assert r["samples"] >= 1024 and -1.0 <= r["speaker_sim"] <= 1.0
    assert report["speaker_sim_min"] <= report["speaker_sim_mean"]
    assert json.loads((tmp_path / "r.json").read_text(encoding="utf-8")) == report


def test_gate_failures_are_loud(model_dir, tmp_path, monkeypatch):
    """Missing checkpoints are refused (random weights must not pass a weight
    gate), and a speaker-sim threshold that is not met raises."""
    d = tmp_path / "model"
    d.mkdir()
    Config().save(str(d / "config.yaml"))
    with pytest.raises(FileNotFoundError, match="missing"):
        verify.verify_model_dir(str(d), prompt_wav=str(tmp_path / "p.wav"), device="cpu")
    synthetic = verify.make_synthetic_model_dir(str(tmp_path / "synthetic"))
    records = [{"speaker_sim": 0.4}, {"speaker_sim": 0.6}]
    monkeypatch.setattr(verify, "run_battery", lambda *a, **k: records)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="speaker-sim gate failed: mean 0.5 < 0.9"):
            verify.verify_model_dir(synthetic, prompt_wav=str(model_dir / "prompt.wav"),
                                    min_speaker_sim=0.9, device="cpu")


# -- profiling, the bench tools, the entry --------------------------------

def test_phase_timer_and_device_trace(tmp_path):
    timer = profiling.PhaseTimer()
    with timer.phase("decode"):
        pass
    with timer.phase("decode"):
        pass
    assert set(timer.phases) == {"decode"} and "RTF" in timer.report(1.0)
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("tools.region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(prof.trace_path, encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "tools.region" in names
    with profiling.device_trace(None) as off:       # no directory, no INDEXTTS_TRACE_DIR
        assert off is None


TINY_RUNS = {
    "bench": (bench.main, ["--tiny", "--batch", "1", "--max-new", "6", "--warmup", "1",
                           "--iters", "1"], {"metric", "value", "results", "launches"}),
    "bench batched": (bench.main, ["--tiny", "--batch", "2", "--max-new", "6", "--warmup", "1",
                                   "--iters", "1"], {"metric", "value", "results"}),
    "bench_beam_step": (bench_beam_step.main, ["--tiny", "--reorders", "lineage,pallas",
                                               "--max-new", "6", "--text-len", "10",
                                               "--warmup", "1", "--iters", "1"],
                        {"metric", "results"}),
    "bench_beam_pool": (bench_beam_pool.main, ["--tiny", "--groups", "2", "--reqs", "3"],
                        {"metric", "value", "launches"}),
    "bench_pool": (bench_pool.main, ["--tiny", "--slots", "4", "--reqs", "5", "--iters", "1",
                                     "--steps-per-tick", "4"], {"metric", "value", "launches"}),
    "bench_pool_trunk": (bench_pool_trunk.main, ["--tiny", "--slots", "4", "--steps", "3",
                                                 "--t", "64"], {"metric", "results"}),
    "entry": (entry.main, ["--tiny"], {"loss_text", "loss_mel", "finite"}),
    "eval_quality": (eval_quality.main, ["--self-test"], {"speaker_sim_self", "ok"}),
}


@pytest.mark.parametrize("name", sorted(TINY_RUNS))
def test_tool_prints_one_json_line(name, capsys):
    """Each tool at a tiny size on the CPU prints its result as one JSON line
    with its metric keys and the device it ran on.  No timing is asserted."""
    main, argv, keys = TINY_RUNS[name]
    result = main(argv + ["--device", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(result))
    assert keys <= set(result) and result["device"]["name"] == "cpu"
    if name == "entry":
        assert result["finite"]
    if name == "eval_quality":
        assert result["ok"] and abs(result["speaker_sim_self"] - 1.0) < 1e-4
    if name == "bench_pool_trunk":
        assert [r["impl"] for r in result["results"]] == ["rows", "flat", "fused"]


@pytest.mark.parametrize("argv", [["--e2e", "--tiny", "--clients", "2", "--reqs", "2",
                                   "--slots", "4"], None])
def test_e2e_tools(model_dir, argv, capsys):
    """bench_pool --e2e (clients over pool_infer_stream) and bench_e2e (infer
    and infer_stream) on the tiny engine: every request and mode reported."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if argv:
            result = bench_pool.main(argv + ["--device", "cpu"])
            assert result["requests"] == 2 and result["audio_sec_per_sec"] > 0
        else:
            result = bench_e2e.main(["--model_dir", str(model_dir), "--max-mel-tokens", "4",
                                     "--prompt", str(model_dir / "prompt.wav"),
                                     "--device", "cpu"])
            assert set(result["modes"]) == {"infer", "infer_stream"}
            assert all(m["audio_s"] > 0 for m in result["modes"].values())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metric"] == \
        result["metric"]


@pytest.mark.parametrize("main", [bench.main, bench_e2e.main, bench_pool.main,
                                  bench_beam_step.main, bench_beam_pool.main,
                                  bench_pool_trunk.main, entry.main, eval_quality.main,
                                  export_pth.main])
def test_tools_default_to_the_card(main):
    """Without --device the tools take the card, and without one they stop."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    argv = {export_pth.main: ["dvae", "--ckpt", "x", "--out", "y"], bench_e2e.main: [],
            eval_quality.main: ["--self-test"]}.get(main, ["--tiny"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
