"""Command line of the port: ``convert`` a file with a user's model files.

    python -m rvc_tpu_torch.cli.main convert in.wav out.wav --model model.pth \
        --hubert content-vec-best.safetensors --rmvpe rmvpe.pt [--index bank.npy] \
        [--resample-sr 44100] [--device cpu]

The arguments and steps of ``rvc_tpu/cli/main.py``'s ``convert``, plus
``--device`` (the card unless ``cpu`` is asked for). The JAX package's other
subcommands (separate, preprocess, train, index) wait for their modules.
"""
from __future__ import annotations

import argparse


def _add_convert(sub) -> None:
    p = sub.add_parser("convert", help="RVC voice conversion")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--model", required=True, help=".pth checkpoint")
    p.add_argument("--hubert", required=True, help="content-vec safetensors")
    p.add_argument("--rmvpe", default="", help="rmvpe.pt (for f0_method=rmvpe)")
    p.add_argument("--index", default="", help="retrieval bank .npy")
    p.add_argument("--f0-up-key", type=float, default=0)
    p.add_argument("--f0-method", default="rmvpe")
    p.add_argument("--index-rate", type=float, default=0.75)
    p.add_argument("--protect", type=float, default=0.33)
    p.add_argument("--rms-mix-rate", type=float, default=0.25)
    p.add_argument("--resample-sr", type=int, default=0)
    p.add_argument("--sid", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def cmd_convert(args) -> None:
    import numpy as np

    from ..compat.torch_import import (load_hubert_safetensors, load_rmvpe,
                                       load_rvc_checkpoint, synthesizer_kwargs_from_config)
    from ..io.audio import load_input_audio, save_input_audio
    from ..pipelines.convert import ConvertSettings, VoiceConverter

    state, meta = load_rvc_checkpoint(args.model)
    kwargs = synthesizer_kwargs_from_config(meta["config"], meta["version"], bool(meta["f0"]))
    hubert_state, hubert_cfg = load_hubert_safetensors(args.hubert)
    rmvpe_state = load_rmvpe(args.rmvpe) if args.rmvpe else None
    bank = np.load(args.index) if args.index else None
    vc = VoiceConverter.from_state_dicts(state, kwargs, hubert_state, hubert_cfg, rmvpe_state,
                                         index_bank=bank, device=args.device)
    audio, sr = load_input_audio(args.input, 16000)
    out, out_sr = vc.convert(audio, sr, ConvertSettings(
        sid=args.sid, f0_up_key=args.f0_up_key, f0_method=args.f0_method,
        index_rate=args.index_rate, protect=args.protect,
        rms_mix_rate=args.rms_mix_rate, resample_sr=args.resample_sr))
    save_input_audio(args.output, (out, out_sr))
    print(f"wrote {args.output} ({out_sr} Hz)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("rvc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_convert(sub)
    args = parser.parse_args(argv)
    {"convert": cmd_convert}[args.cmd](args)


if __name__ == "__main__":
    main()
