"""The dry run of several devices: one data-parallel training step over
spawned ranks, then a conversion with its chunk batch split over devices,
on tiny shapes.

Counterpart of ``rvc_tpu/parallel/dryrun.py:13-128, 150-197`` (and of
``__graft_entry__.dryrun_multichip``):

    python -m rvc_tpu_torch.parallel.dryrun --n-devices 2 [--device cpu]

(the cards by default: rank r on ``cuda:r``). Stage 1 runs ``Trainer.step``
under a world of ``n_devices`` ranks (gloo on the CPU, NCCL on the cards)
on a global batch of 2 rows a rank, from seeded weights and draws: every
metric finite, the step count 1, and the losses within ``LOSS_TOL`` of one
process's step on the whole batch, on rank 0's device.
Stage 2 converts two songs with ``VoiceConverter(devices=[...])`` (a tiny
HuBERT, no RMVPE, f0 by "pm", an int8 bank) and holds the int16 output
equal to the single-device call's. The cards run ``card_config()``, the
narrowest widths their kernels take; the CPU runs JAX's ``tiny_config()``. JAX's stage 2, the 2-D ``(dp, tp)``
mesh, has no training or conversion path that uses it and is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time

import numpy as np
import torch

LOSS_TOL = 1e-5  # relative to max(1, |loss|): float32 sums in another order


def make_tiny_batch(n: int, seed: int = 0, feature_dim: int = 768) -> dict:
    """A numpy batch of ``n`` rows at ``tiny_config()``'s shapes (the JAX
    dry run's, with the v2 features' width)."""
    rng = np.random.default_rng(seed)
    T, seg, hop, spec_ch = 24, 640, 64, 33
    return {
        "phone": rng.standard_normal((n, T, feature_dim)).astype(np.float32),
        "phone_lengths": np.full((n,), T, np.int32),
        "pitch": rng.integers(1, 255, (n, T)).astype(np.int32),
        "pitchf": rng.uniform(100, 300, (n, T)).astype(np.float32),
        "spec": rng.standard_normal((n, T, spec_ch)).astype(np.float32),
        "spec_lengths": np.full((n,), T, np.int32),
        "wave": (0.1 * rng.standard_normal((n, T * hop + seg))).astype(np.float32),
        "sid": np.zeros((n,), np.int32),
    }


def tiny_config():
    """rvc_tpu/parallel/dryrun.py::tiny_config: 6.4 kHz, widths of 8-16,
    the discriminators at 1/16 width."""
    from ..config import DataConfig, ModelConfig, RVCConfig, TrainConfig

    return RVCConfig(
        data=DataConfig(sampling_rate=6400, filter_length=64, hop_length=64, win_length=64,
                        n_mel_channels=16),
        model=ModelConfig(
            inter_channels=8, hidden_channels=8, filter_channels=16, n_heads=2, n_layers=1,
            kernel_size=3, resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            upsample_rates=(8, 4, 2), upsample_initial_channel=16,
            upsample_kernel_sizes=(16, 8, 4), gin_channels=8, spk_embed_dim=2, version="v2",
            use_f0=True, disc_scale=1.0 / 16.0),
        train=TrainConfig(batch_size=8, segment_size=640, c_hd=0.0, c_tsi=0.0, c_tefs=0.0))


def card_config():
    """``tiny_config()`` at the narrowest widths the port's kernels take on
    the card (channels a multiple of 16, attention heads of 32): the
    synthesizer's hidden width 64, the decoder's 128 down to 16."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, inter_channels=16, hidden_channels=64, filter_channels=64,
        upsample_initial_channel=128, gin_channels=16))


def params_digest(modules) -> str:
    """sha1 of every parameter's bytes, in order: equal on every rank of a
    step whose gradients were summed."""
    h = hashlib.sha1()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_steps(world, config, batches: list, draws: list | None = None, state_g=None,
             state_d=None, seed: int = 0, keep_params: int = 0, counters: dict | None = None,
             events: bool = False, device=None) -> dict:
    """``Trainer.step`` on this rank over the global ``batches`` (one step
    each; ``draws[i]`` the i-th step's global draws, or ``Trainer.draws``
    seeded with the step), from reference-named numpy state_dicts or
    ``seed``'s random weights. ``world`` None is one process on ``device``.
    Returns the metrics per step (floats), each step's wall ms (the host's
    clock, the card synchronized), the parameters' digest, the parameters
    after each of the first ``keep_params`` steps (CPU tensors by name, "g."
    and "d." prefixed), with ``counters`` ({name: (object, attribute)})
    their counts over the steps (set to 0 before the first), and with
    ``events`` each step's stage ms on the card."""
    from ..train.step import Trainer

    trainer = Trainer(config, device=device, world=world)
    state = trainer.init_state(seed=seed, state_g=state_g, state_d=state_d)
    if world is not None:
        from .mesh import replicate

        replicate(world, (trainer.synth, trainer.disc), state)
    cuda = trainer.device.type == "cuda"
    for obj, attr in (counters or {}).values():
        setattr(obj, attr, 0)
    out = {"metrics": [], "wall_ms": [], "params": [], "stages": []}
    for i, batch in enumerate(batches):
        ev = [] if events else None
        step_draws = None if draws is None else {k: torch.as_tensor(v).to(trainer.device)
                                                 for k, v in draws[i].items()}
        if cuda:
            torch.cuda.synchronize(trainer.device)
        t0 = time.perf_counter()
        state, m = trainer.step(state, batch, draws=step_draws, events=ev)
        if cuda:
            torch.cuda.synchronize(trainer.device)
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items() if k != "viz"})
        if ev:
            out["stages"].append({name: a.elapsed_time(b)
                                  for (_, a), (name, b) in zip(ev[:-1], ev[1:])})
        if i < keep_params:
            out["params"].append({f"{p}.{k}": v.detach().cpu().clone() for p, mod in
                                  (("g", trainer.synth), ("d", trainer.disc))
                                  for k, v in mod.state_dict().items()})
    out.update(step=state.step, digest=params_digest((trainer.synth, trainer.disc)))
    if counters:
        out["launches"] = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    return out


def _config(device: str):
    return tiny_config() if device == "cpu" else card_config()


def _stage1(n: int, device: str) -> None:
    from .mesh import rank_device, spawn

    cfg = _config(device)
    batch = make_tiny_batch(2 * n)
    ranks = spawn(dp_steps, n, device, args=(cfg, [batch]))
    ref = dp_steps(None, cfg, [batch], device=rank_device(device, 0))
    digests = {r["digest"] for r in ranks}
    for r in ranks:
        assert r["step"] == 1, r["step"]
        for k, v in r["metrics"][0].items():
            assert np.isfinite(v), (k, v)
    if len(digests) != 1:
        raise AssertionError("the ranks' parameters differ after the step")
    worst = max(abs(v - ref["metrics"][0][k]) / max(1.0, abs(ref["metrics"][0][k]))
                for k, v in ranks[0]["metrics"][0].items() if not k.startswith("grad_norm"))
    if worst > LOSS_TOL:
        raise AssertionError(f"the dp step's losses are {worst:.3g} from one process's")
    m = ranks[0]["metrics"][0]
    print(f"dryrun dp step OK over {n} ranks on {device}: loss_gen_all "
          f"{m['loss_gen_all']:.4f}, loss_disc {m['loss_disc']:.4f}, losses within "
          f"{worst:.3g} of one process's step on the whole batch", flush=True)


def tiny_converter(device: str, seed: int = 0, config=None):
    """A converter at ``config``'s widths (``tiny_config()``'s by default)
    with a 2-layer HuBERT of width 32, no RMVPE and a 512-row int8 bank
    (the JAX dry run's)."""
    from ..models.hubert import HubertConfig, HubertEncoder
    from ..models.layers import init_random_
    from ..models.synthesizer import Synthesizer
    from ..pipelines.convert import VoiceConverter, synth_kwargs_from_config
    from ..pitch.extractor import PitchExtractor

    cfg = dataclasses.replace(config or tiny_config(), x_pad=1, x_query=2, x_center=3, x_max=5)
    kwargs = {**synth_kwargs_from_config(cfg), "feature_dim": 32}
    hub = HubertConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                       intermediate_size=64, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                       num_conv_pos_embedding_groups=4)
    bank = np.random.default_rng(seed + 7).standard_normal((512, 32)).astype(np.float32)
    return VoiceConverter(init_random_(Synthesizer(**kwargs), seed), kwargs,
                          init_random_(HubertEncoder(hub, "v2"), seed + 1), PitchExtractor(),
                          index_bank=bank, config=cfg, index_int8=True, device=device,
                          seed=seed)


def _stage2(n: int, device: str) -> None:
    from ..pipelines.convert import ConvertSettings

    devices = [device] * n if device == "cpu" else [f"cuda:{i}" for i in range(n)]
    vc = tiny_converter(devices[0], config=_config(device))
    rng = np.random.default_rng(0)
    songs = [(0.3 * np.sin(2 * np.pi * 180 * np.arange(16000 * sec) / 16000)
              + 0.01 * rng.standard_normal(16000 * sec)).astype(np.float32) for sec in (8, 4)]
    s = ConvertSettings(f0_method="pm", index_rate=0.75, rms_mix_rate=1.0)
    one = vc.convert_batch(songs, settings=s)
    vc.devices = devices
    split = vc.convert_batch(songs, settings=s)
    for (a, sr), (b, _), src in zip(one, split, songs):
        assert a.dtype == np.int16 and abs(len(a) - len(src) * sr // 16000) <= sr // 50
        assert int(np.abs(a.astype(np.int32)).max()) > 0
        if not np.array_equal(a, b):
            raise AssertionError("the split chunk batch's int16 output differs from one "
                                 "device's")
    print(f"dryrun inference OK over {devices}: {len(songs)} songs, int16 equal to one "
          f"device's, outputs {[len(w) for w, _ in split]} samples at {split[0][1]} Hz",
          flush=True)


def run_dryrun(n_devices: int, device: str = "cuda") -> None:
    """Stage 1 and stage 2 over ``n_devices`` ranks and devices: the cards
    (``cuda:0`` ... ``cuda:n-1``), or ``device="cpu"``'s processes. More
    ranks than cards raises."""
    from .mesh import make_mesh

    make_mesh(n_devices, 2 * n_devices, device)
    t0 = time.perf_counter()
    _stage1(n_devices, device)
    _stage2(n_devices, device)
    print(f"[dryrun] all stages OK in {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-devices", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    a = p.parse_args(argv)
    run_dryrun(a.n_devices, a.device)


if __name__ == "__main__":
    main()
