"""Typed configuration schema for the PyTorch port of IndexTTS.

A copy of the JAX package's schema (indextts_tpu/config.py), kept in this
package so the port never imports the JAX one.  It mirrors the reference
OmegaConf YAML layout (finetune_models/config.yaml:1-276) as plain
dataclasses; unknown keys are ignored.  The package reads and writes that
YAML itself (`load_yaml`, `to_yaml`), with no YAML package: the subset that
config files use, scalars resolved as `yaml.safe_load` resolves them
(YAML 1.1), and an error naming the line for anything outside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def _filter_kwargs(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _sub(cls, d: Optional[Dict[str, Any]]):
    if d is None:
        return cls()
    return cls(**_filter_kwargs(cls, d))


@dataclass(frozen=True)
class MelConfig:
    """Mel-spectrogram front-end (reference: config.yaml:43-50,
    indextts/utils/feature_extractors.py:43-60)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 100
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None
    normalize: bool = False


@dataclass
class DatasetConfig:
    bpe_model: str = "bpe.model"
    sample_rate: int = 24000
    squeeze: bool = False
    mel: MelConfig = field(default_factory=MelConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DatasetConfig":
        d = dict(d or {})
        mel = _sub(MelConfig, d.pop("mel", None))
        return cls(mel=mel, **_filter_kwargs(cls, d))


@dataclass(frozen=True)
class ConditionModuleConfig:
    """Conformer conditioning encoder (reference: config.yaml:68-74)."""

    output_size: int = 512
    linear_units: int = 2048
    attention_heads: int = 8
    num_blocks: int = 6
    input_layer: str = "conv2d2"
    perceiver_mult: int = 2


# the condition_types that run the conformer -> perceiver path; the others
# ("perceiver" and the mean-pooled default) run the legacy encoder
CONFORMER_CONDITION_TYPES = ("conformer_perceiver", "conformer_encoder")


@dataclass(frozen=True)
class GPTConfig:
    """UnifiedVoice acoustic model (reference: config.yaml:52-74,
    indextts/gpt/model.py:312-374)."""

    model_dim: int = 1280
    max_mel_tokens: int = 800
    max_text_tokens: int = 600
    heads: int = 20
    use_mel_codes_as_input: bool = True
    mel_length_compression: int = 1024
    layers: int = 24
    number_text_tokens: int = 12000
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    start_text_token: int = 0
    stop_text_token: int = 1
    train_solo_embeddings: bool = False
    condition_type: str = "conformer_perceiver"
    condition_num_latent: int = 32
    max_conditioning_inputs: int = 1
    checkpointing: bool = False
    activation_function: str = "gelu_new"
    types: int = 1
    condition_module: ConditionModuleConfig = field(default_factory=ConditionModuleConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GPTConfig":
        d = dict(d or {})
        cm = _sub(ConditionModuleConfig, d.pop("condition_module", None))
        return cls(condition_module=cm, **_filter_kwargs(cls, d))

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.heads

    @property
    def max_text_seq_len(self) -> int:
        # reference: gpt/model.py:372-374 (max_text_tokens + 2)
        return self.max_text_tokens + 2

    @property
    def max_mel_seq_len(self) -> int:
        # reference: gpt/model.py:372-374 (max_mel_tokens + 2 + max_conditioning_inputs)
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs


@dataclass(frozen=True)
class VQVAEConfig:
    """DVAE mel tokenizer (reference: config.yaml:76-87,
    indextts/vqvae/xtts_dvae.py:205-309)."""

    channels: int = 100
    num_tokens: int = 8192
    hidden_dim: int = 512
    num_resnet_blocks: int = 3
    codebook_dim: int = 512
    num_layers: int = 2
    positional_dims: int = 1
    kernel_size: int = 3
    smooth_l1_loss: bool = True
    use_transposed_convs: bool = False
    stride: int = 2
    activation: str = "relu"


@dataclass
class BigVGANConfig:
    """BigVGAN generator (reference: config.yaml:88-148,
    indextts/BigVGAN/models.py:130-201)."""

    resblock: str = "1"
    upsample_rates: List[int] = field(default_factory=lambda: [4, 4, 4, 4, 2, 2])
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [8, 8, 4, 4, 4, 4])
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5], [1, 3, 5], [1, 3, 5]]
    )
    feat_upsample: bool = False
    speaker_embedding_dim: int = 512
    cond_d_vector_in_each_upsampling_layer: bool = True
    gpt_dim: int = 1280
    activation: str = "snakebeta"
    snake_logscale: bool = True
    num_mels: int = 100
    sampling_rate: int = 24000
    # The reference's `use_fused_kernel` key is not a field: the port's
    # activations run the kernel on CUDA tensors and its plain version on CPU ones.


@dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter settings (reference: config.yaml:244-252).
    Frozen/hashable so it can be a jit static argument."""

    r: int = 4
    lora_alpha: int = 8
    lora_dropout: float = 0.2
    target_modules: tuple = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")

    def __post_init__(self):
        if isinstance(self.target_modules, list):
            object.__setattr__(self, "target_modules", tuple(self.target_modules))


@dataclass
class OptimizerConfig:
    learning_rate: float = 5.0e-6
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    loraplus_lr_ratio: float = 2.0


@dataclass
class TrainConfig:
    """Fine-tune trainer settings (reference: config.yaml:148-252)."""

    finetune_model_dir: str = "finetune_models"
    seed: int = 91
    epochs: int = 15
    batch_size: int = 128
    valid_batch_size: int = 256
    num_workers: int = 0
    lazy_load_metadata: bool = True
    cross_speaker_ratio: float = 0.0
    cfg_dropout_ratio: float = 0.0
    gradient_accumulation_steps: int = 16
    max_grad_norm: float = 1.0
    text_weight: float = 0.1
    early_stopping_patience: int = 1
    max_steps_per_epoch: int = 150
    data_path: str = "finetune_data/processed_data/"
    mixed_precision: str = "auto"
    save_dtype: str = "bf16"
    min_text_length: int = 0
    max_text_length: int = 0
    text_length_weights: Dict[int, float] = field(default_factory=dict)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lora: LoRAConfig = field(default_factory=LoRAConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainConfig":
        d = dict(d or {})
        opt = _sub(OptimizerConfig, d.pop("optimizer", None))
        lora = _sub(LoRAConfig, d.pop("lora", None))
        return cls(optimizer=opt, lora=lora, **_filter_kwargs(cls, d))


@dataclass
class QuantizationConfig:
    enabled: bool = False
    weight_dtype: str = "int8"
    compute_dtype: str = "bf16"


@dataclass
class InferenceConfig:
    """Inference precision tiers (reference: config.yaml:264-276,
    indextts/infer.py:213-306)."""

    gpt: str = "bf16"
    vocoder: str = "bf16"
    cfg_scale: float = 1.0
    # KV-cache storage: "auto" = fp8 when weight quantization is on,
    # bf16 otherwise; "fp8" / "bf16" force a tier (engine.py)
    kv_cache: str = "auto"
    quantization: QuantizationConfig = field(default_factory=QuantizationConfig)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "InferenceConfig":
        d = dict(d or {})
        q = _sub(QuantizationConfig, d.pop("quantization", None))
        return cls(quantization=q, **_filter_kwargs(cls, d))


@dataclass
class ExtractConfig:
    """Codec extraction (reference: config.yaml:22-36)."""

    batch_size: int = 16
    num_workers: int = 8
    medoid_batch_size: int = 10000
    medoid_chunk_size: int = 20000


@dataclass
class WorkflowPaths:
    data_source_dir: str = "data"
    audio_list_dir: str = "finetune_data/audio_list"
    processed_data_dir: str = "finetune_data/processed_data"
    log_dir: str = "logs"


@dataclass
class WorkflowConfig:
    paths: WorkflowPaths = field(default_factory=WorkflowPaths)
    extract: ExtractConfig = field(default_factory=ExtractConfig)
    prepare_split_size: int = 100000

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "WorkflowConfig":
        d = dict(d or {})
        paths = _sub(WorkflowPaths, d.pop("paths", None))
        ex = dict(d.pop("extract", {}) or {})
        medoid = dict(d.pop("medoid", {}) or {})
        extract = ExtractConfig(
            batch_size=ex.get("batch_size", 16),
            num_workers=ex.get("num_workers", 8),
            medoid_batch_size=medoid.get("batch_size", 10000),
            medoid_chunk_size=medoid.get("chunk_size", 20000),
        )
        prepare = dict(d.pop("prepare", {}) or {})
        return cls(paths=paths, extract=extract,
                   prepare_split_size=prepare.get("split_size", 100000))


@dataclass
class Config:
    """Top-level config: one YAML drives the whole pipeline
    (reference: finetune_models/config.yaml)."""

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    gpt: GPTConfig = field(default_factory=GPTConfig)
    vqvae: VQVAEConfig = field(default_factory=VQVAEConfig)
    bigvgan: BigVGANConfig = field(default_factory=BigVGANConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    workflow: WorkflowConfig = field(default_factory=WorkflowConfig)
    dvae_checkpoint: str = "dvae.pth"
    gpt_checkpoint: str = "gpt.pth"
    bigvgan_checkpoint: str = "bigvgan_generator.pth"
    version: float = 1.5

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        d = dict(d or {})
        return cls(
            dataset=DatasetConfig.from_dict(d.get("dataset")),
            gpt=GPTConfig.from_dict(d.get("gpt")),
            vqvae=_sub(VQVAEConfig, d.get("vqvae")),
            bigvgan=_sub(BigVGANConfig, d.get("bigvgan")),
            train=TrainConfig.from_dict(d.get("train")),
            inference=InferenceConfig.from_dict(d.get("inference")),
            workflow=WorkflowConfig.from_dict(d.get("workflow")),
            dvae_checkpoint=d.get("dvae_checkpoint", "dvae.pth"),
            gpt_checkpoint=d.get("gpt_checkpoint", "gpt.pth"),
            bigvgan_checkpoint=d.get("bigvgan_checkpoint", "bigvgan_generator.pth"),
            version=float(d.get("version", 1.5)),
        )

    @classmethod
    def load(cls, path: str) -> "Config":
        """Read a config YAML with this module's reader (`load_yaml`): no
        YAML package needed."""
        return cls.from_dict(read_yaml(path))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        """Write the config as YAML, without PyYAML (the card machine has
        none): `Config.load` reads it back to an equal Config."""
        with open(path, "w", encoding="utf-8") as f:
            f.write(to_yaml(self.to_dict()))


# words YAML 1.1 reads as booleans or null when they stand unquoted
_YAML_WORDS = {"y", "yes", "n", "no", "true", "false", "on", "off", "null", "~"}


def _yaml_scalar(x: Any) -> str:
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "true" if x else "false"
    if isinstance(x, int):
        return str(x)
    if isinstance(x, float):
        if math.isnan(x):
            return ".nan"
        if math.isinf(x):
            return ".inf" if x > 0 else "-.inf"
        r = repr(x)
        # YAML 1.1 reads an exponent as a float only after a dot ("5.0e-06")
        if "e" in r and "." not in r:
            r = r.replace("e", ".0e")
        return r
    if isinstance(x, str):
        return json.dumps(x, ensure_ascii=False)   # a double-quoted YAML scalar
    raise TypeError(f"cannot write a {type(x).__name__} as YAML")


def _yaml_key(k: Any) -> str:
    if isinstance(k, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", k) \
            and k.lower() not in _YAML_WORDS:
        return k
    return _yaml_scalar(k)


def _yaml_flow(x: Any) -> str:
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_yaml_flow(v) for v in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{_yaml_key(k)}: {_yaml_flow(v)}" for k, v in x.items()) + "}"
    return _yaml_scalar(x)


def to_yaml(tree: Dict[str, Any], indent: int = 0) -> str:
    """A tree of dicts, lists and scalars as block-style YAML (nested
    mappings as blocks, lists and empty mappings in flow style)."""
    pad = " " * indent
    lines = []
    for k, v in tree.items():
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{_yaml_key(k)}:\n{to_yaml(v, indent + 2)}")
        else:
            lines.append(f"{pad}{_yaml_key(k)}: {_yaml_flow(v)}\n")
    return "".join(lines)


# -- reading YAML -------------------------------------------------------------
# The implicit scalar types of PyYAML's SafeLoader (YAML 1.1; yaml/resolver.py
# and yaml/constructor.py of PyYAML 6): a plain scalar that matches none of
# these is a string.
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
# forms safe_load reads as something this reader does not build: dates and
# times, the merge key and the value key
_UNSUPPORTED = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                            (?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9].*)?
                            |<<|=)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class YAMLError(ValueError):
    """Input outside the subset `load_yaml` reads; the message names the line."""


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for part in reversed(value.split(":")):
        total += cast(part) * base
        base *= 60
    return total


def _yaml_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _yaml_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _resolve_plain(text: str, where: str) -> Any:
    """A plain (unquoted) scalar as safe_load types it."""
    if text == "" or _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    try:
        if _INT.match(text):
            return _yaml_int(text)
        if _FLOAT.match(text):
            return _yaml_float(text)
    except ValueError:   # e.g. "0b_": safe_load fails on it too
        raise YAMLError(f"{where}: cannot read the number {text!r}") from None
    if _UNSUPPORTED.match(text):
        raise YAMLError(f"{where}: {text!r} is a date, a merge or a value key, which this "
                        "reader does not build")
    return text


def _quoted(s: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted scalar that starts at s[i]; returns (value, index after it)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = s[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[j + 2:j + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    raise YAMLError(f"{where}: bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                j += 2 + n
            else:
                raise YAMLError(f"{where}: unknown escape \\{e} in a double-quoted string")
            continue
        out.append(c)
        j += 1
    raise YAMLError(f"{where}: a quoted string runs past the end of its line (multi-line "
                    "strings are not read)")


def _check_plain_start(text: str, where: str) -> None:
    c = text[:1]
    if c in ("&", "*", "!"):
        raise YAMLError(f"{where}: anchors, aliases and tags are not read")
    if c in ("|", ">"):
        raise YAMLError(f"{where}: block scalars are not read")
    if c in ("%", "@", "`") or (c in ("?", "-", ":") and text[1:2] in ("", " ", "\t")):
        raise YAMLError(f"{where}: cannot read {text!r}")


def _comment_or_end(s: str, i: int, where: str) -> None:
    rest = s[i:]
    if rest.strip() and not (rest[:1] in (" ", "\t") and rest.strip().startswith("#")):
        raise YAMLError(f"{where}: unexpected {rest.strip()!r}")


def _flow(s: str, i: int, where: str) -> Tuple[Any, int]:
    """The flow collection ([...] or {...}) that starts at s[i], on one line."""
    close = "]" if s[i] == "[" else "}"
    items: List[Any] = []
    pairs: Dict[Any, Any] = {}
    j = i + 1

    def skip(j):
        while j < len(s) and s[j] in " \t":
            j += 1
        return j

    def node(j, stops):
        j = skip(j)
        if j >= len(s):
            raise YAMLError(f"{where}: a flow collection runs past the end of its line")
        if s[j] in "[{":
            return _flow(s, j, where)
        if s[j] in "'\"":
            return _quoted(s, j, where)
        k = j
        while k < len(s) and s[k] not in stops and not (s[k] == ":" and s[k + 1:k + 2] in
                                                         ("", " ", "\t", ",", close)):
            if s[k] == "#" and s[k - 1] in " \t":
                raise YAMLError(f"{where}: a comment inside a flow collection")
            k += 1
        text = s[j:k].rstrip()
        if not text:
            raise YAMLError(f"{where}: an empty entry in a flow collection")
        _check_plain_start(text, where)
        return _resolve_plain(text, where), k

    j = skip(j)
    if s[j:j + 1] == close:
        return ({} if close == "}" else []), j + 1
    while True:
        value, j = node(j, ",[]{}")
        j = skip(j)
        if close == "}":
            if s[j:j + 1] != ":":
                raise YAMLError(f"{where}: a flow mapping entry needs 'key: value'")
            key = value
            value, j = node(j + 1, ",[]{}")
            j = skip(j)
            if isinstance(key, (list, dict)):
                raise YAMLError(f"{where}: a collection as a mapping key is not read")
            pairs[key] = value
        elif s[j:j + 1] == ":":
            raise YAMLError(f"{where}: a mapping inside a flow sequence is not read")
        else:
            items.append(value)
        if s[j:j + 1] == close:
            return (pairs if close == "}" else items), j + 1
        if s[j:j + 1] != ",":
            raise YAMLError(f"{where}: expected ',' or {close!r} in a flow collection")
        j = skip(j + 1)


def _inline_value(s: str, where: str) -> Any:
    """A value written on its key's or dash's line: a flow collection, a
    quoted scalar or a plain scalar, then an optional comment."""
    if s[:1] in ("[", "{"):
        value, j = _flow(s, 0, where)
        _comment_or_end(s, j, where)
        return value
    if s[:1] in ("'", '"'):
        value, j = _quoted(s, 0, where)
        _comment_or_end(s, j, where)
        return value
    _check_plain_start(s, where)
    m = re.search(r"[ \t]#", s)
    text = (s[:m.start()] if m else s).rstrip()
    if re.search(r":(?:[ \t]|$)", text):
        raise YAMLError(f"{where}: a mapping value is not allowed here")
    return _resolve_plain(text, where)


def _split_key(s: str, where: str) -> Optional[Tuple[Any, str]]:
    """(key, the text after its colon) when the line holds 'key: ...', else
    None."""
    if s[:1] in ("'", '"'):
        key, j = _quoted(s, 0, where)
        rest = s[j:].lstrip(" \t")
        if not rest.startswith(":"):
            return None
        if rest[1:2] not in ("", " ", "\t"):
            raise YAMLError(f"{where}: expected ': ' after a quoted key")
        return key, rest[1:].lstrip(" \t")
    if s[:1] in ("[", "{"):
        _, j = _flow(s, 0, where)
        if s[j:].lstrip(" \t").startswith(":"):
            raise YAMLError(f"{where}: a collection as a mapping key is not read")
        return None
    m = re.search(r"[ \t]#|:(?:[ \t]|$)", s)
    if not m or m.group(0).endswith("#"):
        return None
    text = s[:m.start()].rstrip()
    _check_plain_start(text, where)
    return _resolve_plain(text, where), s[m.end():].lstrip(" \t")


def load_yaml(text: str) -> Any:
    """Read one YAML document, as `yaml.safe_load` would, for the subset that
    config files use: block mappings and block sequences (nested, and '- - x'
    on one line), flow collections on one line, comments, plain, single- and
    double-quoted scalars, with plain scalars typed by YAML 1.1's rules.
    Anything else (anchors, aliases, tags, block scalars, multi-line
    scalars, several documents, dates) raises YAMLError naming the line."""
    lines: List[List[Any]] = []          # [indent, content, line number]
    started = False
    for n, raw in enumerate(text.lstrip("﻿").split("\n"), 1):
        raw = raw.rstrip("\r")
        content = raw.lstrip(" ")
        if content.startswith("\t") or ("\t" in raw[:len(raw) - len(content)]):
            raise YAMLError(f"line {n}: a tab in the indentation")
        if not content.strip() or content.startswith("#"):
            continue
        indent = len(raw) - len(content)
        if indent == 0 and content.startswith(("---", "...")) and \
                content[3:4] in ("", " ", "\t"):
            if content.startswith("---") and not started and not content[3:].strip():
                started = True
                continue
            raise YAMLError(f"line {n}: several documents, or a document marker, are not read")
        if indent == 0 and content.startswith("%"):
            raise YAMLError(f"line {n}: directives are not read")
        started = True
        lines.append([indent, content.rstrip(" \t"), n])
    if not lines:
        return None

    def is_item(content: str) -> bool:
        return content.startswith("-") and content[1:2] in ("", " ")

    def node(i: int, indent: int) -> Tuple[Any, int]:
        return (seq if is_item(lines[i][1]) else mapping)(i, indent)

    def block_after(i: int, indent: int, allow_same_seq: bool) -> Tuple[Any, int]:
        """The block that follows a line whose value is empty: more indented,
        or a sequence at the same indent under a mapping key; else null."""
        if i < len(lines):
            ind, content, _ = lines[i]
            if ind > indent or (allow_same_seq and ind == indent and is_item(content)):
                return node(i, ind)
        return None, i

    def check_next(i: int, indent: int) -> None:
        if i < len(lines) and lines[i][0] > indent:
            raise YAMLError(f"line {lines[i][2]}: unexpected indentation")

    def seq(i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(lines) and lines[i][0] == indent and is_item(lines[i][1]):
            _, content, n = lines[i]
            rest = content[1:]
            body = rest.lstrip(" ")
            if not body or body.startswith("#"):
                value, i = block_after(i + 1, indent, False)
            else:
                # the item's own line, read as if it began at the item's column
                lines[i] = [indent + 1 + len(rest) - len(body), body, n]
                if is_item(body) or _split_key(body, f"line {n}") is not None:
                    value, i = node(i, lines[i][0])
                else:
                    value = _inline_value(body, f"line {n}")
                    i += 1
                    check_next(i, indent)
            out.append(value)
        return out, i

    def mapping(i: int, indent: int) -> Tuple[dict, int]:
        out: Dict[Any, Any] = {}
        while i < len(lines) and lines[i][0] == indent and not is_item(lines[i][1]):
            _, content, n = lines[i]
            where = f"line {n}"
            kv = _split_key(content, where)
            if kv is None:
                raise YAMLError(f"{where}: expected 'key: value', got {content!r}")
            key, rest = kv
            if not rest or rest.startswith("#"):
                value, i = block_after(i + 1, indent, True)
            else:
                value = _inline_value(rest, where)
                i += 1
                check_next(i, indent)
            out[key] = value
        return out, i

    value, i = node(0, lines[0][0])
    if i < len(lines):
        raise YAMLError(f"line {lines[i][2]}: bad indentation")
    return value


def read_yaml(path: str) -> Any:
    """`load_yaml` of a file."""
    with open(path, "r", encoding="utf-8") as f:
        return load_yaml(f.read())
