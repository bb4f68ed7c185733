"""Command line of the port: build a dataset, train, index, convert, separate.

    python -m rvc_tpu_torch.cli.main preprocess clips/ exp/ --sr 40k \
        --hubert content-vec-best.safetensors --rmvpe rmvpe.pt [--device cpu]
    python -m rvc_tpu_torch.cli.main train exp/filelist.txt run/ --preset 40k_v2 \
        [--pretrained-g G.pth --pretrained-d D.pth] [--device cpu]
    python -m rvc_tpu_torch.cli.main index exp/ [--device cpu]
    python -m rvc_tpu_torch.cli.main convert in.wav out.wav --model run/model.pth \
        --hubert content-vec-best.safetensors --rmvpe rmvpe.pt --index exp/index.npy \
        [--resample-sr 44100] [--device cpu]
    python -m rvc_tpu_torch.cli.main separate song.wav stems/ --model HP2-4BAND.pth \
        [--agg 10] [--device cpu]

The arguments, defaults and steps of ``rvc_tpu/cli/main.py``'s subcommands,
plus ``--device`` (the card unless ``cpu`` is asked for). ``--f0-method``
takes each of JAX's methods (pitch.extractor.METHODS): pm, dio and harvest
need no weights, rmvpe and rmvpe+ need ``--rmvpe``; crepe has no weights
flag here, as in JAX, so its methods raise KeyError. ``separate`` picks
the separator from the model file's name (``pipelines.separate.
route_separator``: a UVR5 VR ``.pth``, or an MDX-Net ``.onnx`` whose name
holds "mdx"), separates the file's downmix, as the JAX package's does, and
writes ``vocals.wav`` and ``instrumentals.wav``.
"""
from __future__ import annotations

import argparse
import os


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


def _add_separate(sub) -> None:
    p = sub.add_parser("separate", help="vocal/instrumental separation")
    p.add_argument("input")
    p.add_argument("output_dir")
    p.add_argument("--model", required=True, help="UVR5 VR .pth or MDX-Net .onnx")
    p.add_argument("--agg", type=float, default=10.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def cmd_separate(args) -> None:
    from ..io.audio import load_input_audio, save_input_audio
    from ..pipelines.separate import load_separator, route_separator

    audio, sr = load_input_audio(args.input)
    sep = load_separator(route_separator(args.model), args.model, args.agg, device=args.device)
    out = sep.run_inference(audio, sr)
    os.makedirs(args.output_dir, exist_ok=True)
    for stem in ("vocals", "instrumentals"):
        path = os.path.join(args.output_dir, f"{stem}.wav")
        save_input_audio(path, out[stem])
        print(f"wrote {path}")


def _add_preprocess(sub) -> None:
    p = sub.add_parser("preprocess", help="build a training dataset")
    p.add_argument("input_dir")
    p.add_argument("exp_dir")
    p.add_argument("--sr", default="40k", choices=["32k", "40k", "48k"])
    p.add_argument("--hubert", required=True)
    p.add_argument("--rmvpe", default="")
    p.add_argument("--f0-method", default="rmvpe")
    p.add_argument("--version", default="v2", choices=["v1", "v2"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def cmd_preprocess(args) -> None:
    from ..compat.torch_import import load_hubert_safetensors, load_rmvpe
    from ..config import SR_MAP
    from ..models import rmvpe
    from ..models.layers import load_numpy_state_dict
    from ..pipelines.preprocess import (Preprocess, build_filelist, extract_features,
                                        generate_mute_fixtures, hubert_from_state)
    from ..pitch.extractor import PitchExtractor

    sr = SR_MAP[args.sr]
    hubert_state, hubert_cfg = load_hubert_safetensors(args.hubert)
    hubert = hubert_from_state(hubert_state, hubert_cfg, args.version, args.device)
    model = None
    if args.rmvpe:
        model = rmvpe.RMVPE()
        load_numpy_state_dict(model.model, load_rmvpe(args.rmvpe))
    n = Preprocess(sr, args.exp_dir).run_dir(args.input_dir)
    print(f"sliced {n} clips")
    extract_features(args.exp_dir, hubert, PitchExtractor(model), f0_method=args.f0_method,
                     version=args.version, device=args.device)
    mute = os.path.join(args.exp_dir, "mute")
    generate_mute_fixtures(mute, sr, args.version)
    filelist = build_filelist(args.exp_dir, sr, version=args.version, mute_dir=mute)
    print(f"filelist: {filelist}")


def _add_train(sub) -> None:
    p = sub.add_parser("train", help="train an RVC model")
    p.add_argument("filelist")
    p.add_argument("model_dir")
    p.add_argument("--preset", default="40k_v2")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--pretrained-g", default="")
    p.add_argument("--pretrained-d", default="")
    p.add_argument("--name", default="model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def cmd_train(args) -> None:
    import dataclasses

    from .. import config
    from ..pipelines.train import TrainRunConfig, train_model

    cfg = config.preset(args.preset)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=args.epochs, batch_size=args.batch_size))
    run = TrainRunConfig(
        model_dir=args.model_dir, filelist=args.filelist, total_epochs=args.epochs,
        save_every_epoch=args.save_every, export_name=args.name,
        pretrained_g=args.pretrained_g or None, pretrained_d=args.pretrained_d or None,
        device=args.device)
    print("exported:", train_model(cfg, run))


def _add_index(sub) -> None:
    p = sub.add_parser("index", help="build a retrieval bank from features")
    p.add_argument("exp_dir")
    p.add_argument("--version", default="v2")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def cmd_index(args) -> None:
    import numpy as np

    from ..retrieval.index import train_index

    feat_dir = os.path.join(
        args.exp_dir, "3_feature256" if args.version == "v1" else "3_feature768")
    feats = np.concatenate(
        [np.load(os.path.join(feat_dir, f)) for f in sorted(os.listdir(feat_dir))])
    index = train_index(feats, device=args.device)
    out = os.path.join(args.exp_dir, "index.npy")
    index.save(out)
    print(f"wrote {out} ({index.ntotal} rows)")


COMMANDS = {"convert": (_add_convert, cmd_convert),
            "separate": (_add_separate, cmd_separate),
            "preprocess": (_add_preprocess, cmd_preprocess),
            "train": (_add_train, cmd_train), "index": (_add_index, cmd_index)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("rvc_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for add, _ in COMMANDS.values():
        add(sub)
    args = parser.parse_args(argv)
    COMMANDS[args.cmd][1](args)


if __name__ == "__main__":
    main()
