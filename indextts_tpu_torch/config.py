"""Typed configuration schema for the PyTorch port of IndexTTS.

A copy of the JAX package's schema (indextts_tpu/config.py), kept in this
package so the port never imports the JAX one.  It mirrors the reference
OmegaConf YAML layout (finetune_models/config.yaml:1-276) as plain
dataclasses; unknown keys are ignored.  PyYAML is imported only by
`Config.load`; `Config.save` writes YAML itself, so the defaults and the
trainer work without it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(yaml.safe_load(f))

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
