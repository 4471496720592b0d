"""PyTorch port, configuration files without PyYAML (fault C7): the port's
YAML reader (`config.load_yaml`) against `yaml.safe_load` on the shipped
config, on `Config.save` output, on a LoRA run's config_finetuned.yaml, on
a hand-written file in the reference's style and on every YAML 1.1 scalar
form PyYAML resolves; the forms it refuses; its round trip with `to_yaml`;
and `Config.load` and the CLI's argument path in an interpreter where
importing yaml fails."""

import json
import math
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from indextts_tpu_torch import engine as torch_engine
from indextts_tpu_torch.config import Config, YAMLError, load_yaml, to_yaml
from tests.test_torch_engine import MODEL, REPO

SHIPPED = os.path.join(REPO, "checkpoints_test", "config.yaml")

# the reference's style: comments, flow lists, quoted strings, nesting
HAND_WRITTEN = """\
# IndexTTS fine-tune config (hand-written)
dataset:
    bpe_model: 'bpe.model'      # the tokenizer
    sample_rate: 24000
    mel:
        n_mels: 100
        mel_fmax: ~
gpt:
    model_dim: 1280
    condition_type: "conformer_perceiver"
    condition_module: {output_size: 512, attention_heads: 8, input_layer: conv2d2}
bigvgan:
    resblock: '1'
    upsample_rates: [4, 4, 4, 4, 2, 2]
    resblock_dilation_sizes: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    activation: snakebeta
train:
    learning_rate: 5.0e-06
    text_length_weights: {10: 0.5, 20: 1.5}
    lora:
        target_modules:
          - "attn.c_attn"
          - 'mlp.c_fc'   # comment after a quoted item
    notes: "a \\"quoted\\" line # not a comment \\u00e9"
    path: finetune_data/processed_data/ # a trailing comment
    hash: a#b
    nested:
    - - 1
      - 2
    - [3]
    - key: value
      other: 2
"""

# (text, what yaml.safe_load gives), checked against PyYAML 6
SCALARS = ["null", "~", "Null", "NULL", "", "yes", "No", "On", "OFF", "true", "False",
           "y", "n", "1e-5", "5.0e6", "5.0e-06", ".5", "-.5", "+.5", "1.", "1.e5", "1.e+5",
           "1_000", "0x10", "-0x1f", "012", "09", "0b101", "0o17", "1:30", "-1:30", "1:30.5",
           "1:60", ".inf", "-.inf", "+.inf", ".NaN", "+1", "-0", "00", "0_", "0.5_5", "_1",
           "1_0.5", "3", "-12", "0.0", "-0.0", "abc", "a b", "'quoted'", '"dq \\t"',
           "'it''s'", "tru", "None", r'"\L\P\N\_\e\x41\u00e9\U0001F600\/\ \0"']
REFUSED = {
    "anchor": "a: &x 1\n",
    "alias": "a: &x 1\nb: *x\n",
    "tag": "a: !!int 1\n",
    "second document": "a: 1\n---\nb: 2\n",
    "block scalar": "a: |\n  text\n",
    "multi-line scalar": "a: one\n  two\n",
    "date": "a: 2001-12-14\n",
    "multi-line flow": "a: [1,\n  2]\n",
    "tab indent": "a:\n\tb: 1\n",
    "bad indentation": "a:\n    b: 1\n  c: 2\n",
}


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _lora_config(tmp_path):
    """A LoRA run's config_finetuned.yaml as the port's trainer writes it
    (train/run.py: Config.save of the run's config)."""
    cfg = Config.from_dict({**MODEL, "train": {
        "epochs": 2, "learning_rate": 1e-5, "data_path": str(tmp_path / "data"),
        "finetune_model_dir": str(tmp_path / "out"), "text_length_weights": {10: 0.5},
        "optimizer": {"learning_rate": 2e-5}, "lora": {"r": 8, "target_modules": ["attn.c_attn"]}}})
    path = tmp_path / "config_finetuned.yaml"
    cfg.save(str(path))
    return path.read_text(encoding="utf-8")


@pytest.mark.parametrize("source", ["shipped", "saved defaults", "lora run", "hand-written"])
def test_reader_equals_safe_load(source, tmp_path):
    if source == "shipped":
        text = open(SHIPPED, encoding="utf-8").read()
    elif source == "saved defaults":
        Config().save(str(tmp_path / "c.yaml"))
        text = (tmp_path / "c.yaml").read_text(encoding="utf-8")
    elif source == "lora run":
        text = _lora_config(tmp_path)
    else:
        text = HAND_WRITTEN
    want = yaml.safe_load(text)
    got = load_yaml(text)
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("scalar", SCALARS)
def test_scalars_resolve_as_yaml_1_1(scalar):
    want = yaml.safe_load(f"a: {scalar}\n")
    got = load_yaml(f"a: {scalar}\n")
    assert _same(got, want), (scalar, got, want)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refuses_what_it_does_not_read(case):
    with pytest.raises(YAMLError, match=r"line \d+"):
        load_yaml(REFUSED[case])


def test_round_trip_with_to_yaml(tmp_path):
    """to_yaml writes what load_yaml reads back equal, and Config.load gives
    the saved Config back, floats, empty mappings and int keys included."""
    cfg = Config.from_dict({**MODEL, "train": {"text_length_weights": {10: 0.5}}})
    tree = json.loads(json.dumps(cfg.to_dict(), default=list))
    tree["weird"] = {"nan": float("nan"), "inf": -float("inf"), "tiny": 5e-324,
                     "words": ["yes", "null", "1e-5", "a: b", "#c", "'q'", "\n\t\u00e9"],
                     "empty": {}, "nested": [[1, [2.5, None]], {"k": True}], 3: "three"}
    text = to_yaml(tree)
    assert _same(load_yaml(text), yaml.safe_load(text))
    assert _same(load_yaml(text), tree)
    cfg.save(str(tmp_path / "c.yaml"))
    assert Config.load(str(tmp_path / "c.yaml")) == cfg


def test_engine_reads_config_inference_yaml(tmp_path):
    """The engine's config_inference.yaml goes through the same reader."""
    d = tmp_path / "model"
    d.mkdir()
    Config.from_dict(MODEL).save(str(d / "config.yaml"))
    shutil.copy(os.path.join(REPO, "checkpoints_test", "vocab.txt"), d / "vocab.txt")
    (d / "config_inference.yaml").write_text("inference:\n  gpt: int8   # quantized\n"
                                             "  kv_cache: 'bf16'\n", encoding="utf-8")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tts = torch_engine.IndexTTS(cfg_path=str(d / "config.yaml"), model_dir=str(d),
                                    device="cpu")
    assert tts.use_quantization and tts.quant_weight_dtype == "int8"
    assert tts.kv_cache_dtype is None


def test_config_and_cli_without_pyyaml(tmp_path):
    """In an interpreter where `import yaml` fails, as on the card machine:
    Config.load reads the shipped config, and the CLI's documented command
    with --model_dir checkpoints_test reaches the engine's weights with that
    config (the run stops there: the flagship model is not built here)."""
    prompt = tmp_path / "p.wav"
    wavfile.write(str(prompt), 24000, np.zeros(2400, np.int16))
    code = f"""
import json, sys
sys.modules["yaml"] = None
from indextts_tpu_torch.config import Config
cfg = Config.load({SHIPPED!r})
from indextts_tpu_torch import cli, engine
seen = {{}}
class Stop(Exception):
    pass
def stop(gpt_cfg, *a, **k):
    seen["layers"], seen["dim"] = gpt_cfg.layers, gpt_cfg.model_dim
    raise Stop
engine.uv.init_params = stop
try:
    cli.main(["hi", "-v", {str(prompt)!r}, "-o", {str(tmp_path / "o.wav")!r},
              "--model_dir", "checkpoints_test", "-d", "cpu"])
except Stop:
    pass
print(json.dumps({{"layers": cfg.gpt.layers, "rates": cfg.bigvgan.upsample_rates,
                  "dilations": cfg.bigvgan.resblock_dilation_sizes,
                  "resblock": cfg.bigvgan.resblock, "engine": seen,
                  "yaml_loaded": sys.modules["yaml"] is not None}}))
"""
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"layers": 24, "rates": [4, 4, 4, 4, 2, 2], "dilations": [[1, 3, 5]] * 3,
                   "resblock": "1", "engine": {"layers": 24, "dim": 1280},
                   "yaml_loaded": False}
