"""The port's trained synthesizer -> the reference's inference ``.pth``.

Counterpart of ``rvc_tpu/compat/torch_export.py`` (``synthesizer_state_dict``,
``save_rvc_checkpoint``): fp16 weights, no posterior encoder (``enc_q``),
weight norm kept as ``weight_g``/``weight_v``, the positional ``config``
list and the ``sr``/``f0``/``version``/``info`` keys (reference
training_cli.py:38-74), so that a model trained here loads in any RVC
tool. The port's modules carry the reference's names, the text encoder's
FFN convs as ``conv_1``/``conv_2`` (the JAX exporter writes ``conv.1``/
``conv.2``, a defect of that package; both loaders read ``conv_1``).
"""
from __future__ import annotations

import torch


def synthesizer_state_dict(synth: torch.nn.Module, half: bool = True) -> dict[str, torch.Tensor]:
    """The live synthesizer's weights as host tensors (fp16 unless ``half``
    is false), without ``enc_q``."""
    dtype = torch.float16 if half else torch.float32
    return {k: v.detach().to("cpu", dtype, copy=True)
            for k, v in synth.state_dict().items() if not k.startswith("enc_q.")}


def save_rvc_checkpoint(path: str, synth: torch.nn.Module, config: list, sr: str | int,
                        f0: int = 1, version: str = "v2", epoch: int | str = "",
                        info: str = "") -> None:
    """Write the reference inference checkpoint of ``synth``."""
    torch.save({"weight": synthesizer_state_dict(synth), "config": list(config),
                "info": info or f"{epoch}epoch", "sr": sr, "f0": f0, "version": version},
               path)
