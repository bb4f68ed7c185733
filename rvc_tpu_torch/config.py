"""Typed configuration tree.

Replaces the reference's three config mechanisms — the argparse ``Config``
singleton with GPU sniffing (reference config.py:22-170), the recursive
``HParams`` attr-dict loaded from configs/{32k,40k,48k}[_v2].json
(reference lib/train/utils.py:429-472), and karafan's INI settings — with
one dataclass tree plus JSON (de)serialization.

Presets mirror the reference's configs/*.json exactly so that training
hyper-parameters and model topology stay comparable.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Sequence


def _asdict(obj) -> dict:
    return dataclasses.asdict(obj)


@dataclass(frozen=True)
class DataConfig:
    """Spectral frontend + dataset parameters (reference configs/40k.json:18-27)."""

    max_wav_value: float = 32768.0
    sampling_rate: int = 40000
    filter_length: int = 2048
    hop_length: int = 400
    win_length: int = 2048
    n_mel_channels: int = 125
    mel_fmin: float = 0.0
    mel_fmax: float | None = None

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    """Synthesizer topology (reference configs/40k.json:28-43)."""

    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.0
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (10, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    use_spectral_norm: bool = False
    gin_channels: int = 256
    spk_embed_dim: int = 109
    # v1 uses 256-dim HuBERT features (layer 9 + final_proj), v2 uses 768 (layer 12).
    version: str = "v2"
    # f0-conditioned (NSF decoder) or not (plain HiFiGAN decoder).
    use_f0: bool = True
    # Discriminator-ensemble width multiplier. 1.0 = reference topology
    # (models.py:1024-1146 channel plan; the only value checkpoints exist
    # for). Tiny validation configs (mesh dryruns, compile-structure tests)
    # shrink it so the full 9-discriminator GAN step stays cheap to
    # compile/execute on a virtual-device CPU mesh.
    disc_scale: float = 1.0

    @property
    def feature_dim(self) -> int:
        return 256 if self.version == "v1" else 768


@dataclass(frozen=True)
class TrainConfig:
    """Optimization defaults (reference configs/40k.json:2-17)."""

    log_interval: int = 200
    seed: int = 1234
    epochs: int = 20000
    learning_rate: float = 1e-4
    betas: Sequence[float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 4
    # The reference runs fp16 + GradScaler; on TPU we use bf16 compute with
    # fp32 loss reductions and fp32 params — no scaler needed.
    bf16_run: bool = True
    lr_decay: float = 0.999875
    segment_size: int = 12800
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0
    # Aux loss weights (reference training_cli.py loss wiring; 0 disables).
    c_tsi: float = 0.0
    c_hd: float = 0.0
    c_tefs: float = 0.0
    # WGAN-GP style gradient penalty on the discriminator (reference
    # losses.gradient_norm_loss, enabled via c_gp; 0 disables).
    c_gp: float = 0.0


@dataclass(frozen=True)
class RVCConfig:
    """Top-level config: data + model + train + runtime."""

    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # -- runtime / pipeline chunking (reference config.py:124-141) ---------
    # Seconds of reflect padding per chunk / query window for the silence
    # seek / nominal chunk center / max length before chunking kicks in.
    x_pad: int = 3
    x_query: int = 10
    x_center: int = 60
    x_max: int = 64

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RVCConfig":
        def build(tp, sub):
            fields = {f.name: f for f in dataclasses.fields(tp)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    continue
                kwargs[k] = v
            return tp(**kwargs)

        kwargs: dict[str, Any] = {}
        if "data" in d:
            kwargs["data"] = build(DataConfig, d["data"])
        if "model" in d:
            kwargs["model"] = build(ModelConfig, d["model"])
        if "train" in d:
            kwargs["train"] = build(TrainConfig, d["train"])
        for k in ("x_pad", "x_query", "x_center", "x_max"):
            if k in d:
                kwargs[k] = d[k]
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "RVCConfig":
        return cls.from_dict(json.loads(s))


def _mk(sr: int, hop: int, n_mels: int, segment: int, ups, ups_k, version: str) -> RVCConfig:
    return RVCConfig(
        data=DataConfig(sampling_rate=sr, hop_length=hop, n_mel_channels=n_mels),
        model=ModelConfig(
            upsample_rates=tuple(ups), upsample_kernel_sizes=tuple(ups_k), version=version
        ),
        train=TrainConfig(segment_size=segment),
    )


# Presets matching reference configs/{32k,40k,48k}[_v2].json.
PRESETS: dict[str, RVCConfig] = {
    "32k": _mk(32000, 320, 80, 12800, (10, 4, 2, 2, 2), (16, 16, 4, 4, 4), "v1"),
    "40k": _mk(40000, 400, 125, 12800, (10, 10, 2, 2), (16, 16, 4, 4), "v1"),
    "48k": _mk(48000, 480, 128, 11520, (10, 6, 2, 2, 2), (16, 16, 4, 4, 4), "v1"),
    "32k_v2": _mk(32000, 320, 80, 12800, (10, 8, 2, 2), (20, 16, 4, 4), "v2"),
    "40k_v2": _mk(40000, 400, 125, 12800, (10, 10, 2, 2), (16, 16, 4, 4), "v2"),
    "48k_v2": _mk(48000, 480, 128, 17280, (12, 10, 2, 2), (24, 20, 4, 4), "v2"),
}

SR_MAP = {"32k": 32000, "40k": 40000, "48k": 48000}


def preset(name: str) -> RVCConfig:
    return PRESETS[name]
