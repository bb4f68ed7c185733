"""The dry run of several devices: one data-parallel training step over
spawned ranks, the same step over a 2-D ``(dp, tp)`` mesh, then a
conversion with its chunk batch split over devices, on tiny shapes.

Counterpart of ``rvc_tpu/parallel/dryrun.py`` (and of
``__graft_entry__.dryrun_multichip``):

    python -m rvc_tpu_torch.parallel.dryrun --n-devices 4 [--device cpu]

(the cards by default: rank r on ``cuda:r``). Stage 1 runs ``Trainer.step``
under a world of ``n_devices`` ranks (gloo on the CPU, NCCL on the cards)
on a global batch of 2 rows a rank, from seeded weights and draws: every
metric finite, the step count 1, and the losses within ``LOSS_TOL`` of one
process's step on the whole batch, on rank 0's device. Stage 2, with an
even ``n_devices >= 4``, runs the same step on an ``(n_devices / 2, 2)``
``(dp, tp)`` mesh of the same ranks (JAX's 2 x 2 submesh at four;
``Trainer(mesh=)``: the rows over dp, each parameter's output channels over
tp), holds its losses, gradient norms and parameters to the one-process
step at ``LOSS_TOL`` and prints how many generator parameters are
tp-sharded.
Stage 3 converts two songs with ``VoiceConverter(devices=[...])`` (a tiny
HuBERT, no RMVPE, f0 by "pm", an int8 bank) and holds the int16 output
equal to the single-device call's, within ``SPLIT_LSB`` from three devices
on. The cards run ``card_config()``, the
narrowest widths their kernels take; the CPU runs JAX's ``tiny_config()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import time

import numpy as np
import torch

LOSS_TOL = 1e-5  # relative to max(1, |loss|): float32 sums in another order
# stage 3 from three devices on: one device's int16 against the split's. Its
# four chunks over three or four devices leave a replica one row, and at one
# row the CPU's float32 products sum in another order than at four (measured
# at four: the text encoder's m moves by ~3e-8, the waveform by ~5e-7 of its
# peak, 1 LSB after the peak normalization). One and two devices (two rows a
# replica or more) are held to equality.
SPLIT_LSB = 1


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


def whole_state(module) -> dict:
    """The module's state_dict with every DTensor gathered whole, detached
    (every rank of a mesh calls it in the same order)."""
    from .mesh import gather_tp

    sd = module.state_dict()
    with torch.no_grad():
        return dict(zip(sd, (t.detach() for t in gather_tp(list(sd.values())))))


def params_digest(modules) -> str:
    """sha1 of every parameter's bytes, in order: equal on every rank of a
    step whose gradients were summed."""
    h = hashlib.sha1()
    for m in modules:
        names = {n for n, _ in m.named_parameters()}
        for k, v in whole_state(m).items():
            if k in names:
                h.update(v.cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def dp_steps(world, config, batches: list, draws: list | None = None, state_g=None,
             state_d=None, seed: int = 0, keep_params: int = 0, counters: dict | None = None,
             events: bool = False, device=None, n_tp: int = 1) -> dict:
    """``Trainer.step`` on this rank over the global ``batches`` (one step
    each; ``draws[i]`` the i-th step's global draws, or ``Trainer.draws``
    seeded with the step), from reference-named numpy state_dicts or
    ``seed``'s random weights. ``world`` None is one process on ``device``;
    with ``n_tp`` > 1 the world's ranks form a ``(world.size / n_tp,
    n_tp)`` mesh (``Trainer(mesh=)``), and the result also holds each
    parameter's local shape and whether it is tp-sharded after the steps
    (``shards``), and the number of tp-sharded generator parameters.
    Returns the metrics per step (floats), each step's wall ms (the host's
    clock, the card synchronized), the parameters' digest, the parameters
    after each of the first ``keep_params`` steps (CPU tensors by name, "g."
    and "d." prefixed), with ``counters`` ({name: (object, attribute)})
    their counts over the steps (set to 0 before the first), and with
    ``events`` each step's stage ms on the card."""
    from ..train.step import Trainer
    from .mesh import make_mesh_2d, replicate, tp_sharded

    if n_tp > 1:
        mesh = make_mesh_2d(world.size // n_tp, n_tp, world.device)
        trainer = Trainer(config, device=world.device, mesh=mesh)
    else:
        trainer = Trainer(config, device=device, world=world)
    state = trainer.init_state(seed=seed, state_g=state_g, state_d=state_d)
    if world is not None and n_tp == 1:
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
            out["params"].append({f"{p}.{k}": v.cpu().clone() for p, mod in
                                  (("g", trainer.synth), ("d", trainer.disc))
                                  for k, v in whole_state(mod).items()})
    out.update(step=state.step, digest=params_digest((trainer.synth, trainer.disc)))
    if n_tp > 1:
        out["shards"] = {f"{p}.{k}": (tuple(v.to_local().shape), tp_sharded(v)) for p, mod in
                         (("g", trainer.synth), ("d", trainer.disc))
                         for k, v in mod.named_parameters()}
        out["tp_sharded_g"] = sum(tp_sharded(v) for v in trainer.synth.parameters())
    if counters:
        out["launches"] = {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}
    return out


def _beside(ranks, one) -> tuple:
    """(ranks(), one()): the spawned ranks' run in a thread while this
    process takes the one-process step."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(ranks)
        mine = one()
        return spawned.result(), mine


def _config(device: str):
    return tiny_config() if device == "cpu" else card_config()


def _check_dp(ranks: list, ref: dict, n: int, device: str) -> None:
    """Stage 1's checks: every metric finite, the step count 1, the ranks'
    parameters equal, the losses within ``LOSS_TOL`` of one process's."""
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


N_TP = 2  # stage 2's tp ranks: a (n_devices / 2, 2) mesh, JAX's 2 x 2 at four devices


def tp_distances(ranks: list, one: dict, n_tp: int) -> dict:
    """A dp x tp run's first step (``dp_steps`` with ``n_tp``, every rank's
    result) against one process's on the whole batch (``keep_params=1``):
    the largest loss distance (relative to max(1, |loss|)), gradient-norm
    distance (relative), parameter distance (absolute), whether the ranks'
    gathered parameters are equal (their digests), and whether every rank's
    local parameters are the ``tp_param_spec`` slices of the whole ones."""
    from .mesh import tp_param_spec

    ma, mb = ranks[0]["metrics"][0], one["metrics"][0]
    norms = ("grad_norm_g", "grad_norm_d")
    whole = one["params"][0]
    rank_params = ranks[0]["params"][0]
    sliced = all(
        r["shards"][k] == (((whole[k].shape[0] // n_tp,) + tuple(whole[k].shape[1:]), True)
                           if tp_param_spec(whole[k].shape, n_tp)[-1].is_shard()
                           else (tuple(whole[k].shape), False))
        for r in ranks for k in r["shards"])
    return {"loss": max(abs(ma[k] - mb[k]) / max(1.0, abs(mb[k])) for k in mb
                        if k not in norms),
            "norm": max(abs(ma[k] - mb[k]) / abs(mb[k]) for k in norms),
            "param": max((rank_params[k] - whole[k]).abs().max().item() for k in whole),
            "equal": len({r["digest"] for r in ranks}) == 1,
            "sliced": sliced, "tp_sharded_g": ranks[0]["tp_sharded_g"]}


def _rank_steps(world, cfg, n_tp: int) -> tuple:
    """A rank of stages 1 and 2, in one world: the dp step on 2 rows a rank,
    then with ``n_tp`` > 1 the dp x tp step on 2 rows a dp rank."""
    dp = dp_steps(world, cfg, [make_tiny_batch(2 * world.size)])
    if n_tp == 1:
        return dp, None
    return dp, dp_steps(world, cfg, [make_tiny_batch(2 * world.size // n_tp)], keep_params=1,
                        n_tp=n_tp)


def _stages_1_2(n: int, device: str) -> dict | None:
    """Stage 1, and with ``n`` >= 4 and even stage 2: the step over an (n /
    2, 2) (dp, tp) mesh against one process's on the same batch of 2 rows a
    dp rank: losses, gradient norms and updated parameters within
    ``LOSS_TOL``, the ranks' parameters equal, the local parameters still
    the tp slices. Both run in one spawned world, the one-process steps
    beside it. Returns stage 2's ranks' and one process's ``dp_steps``
    results, or None."""
    from .mesh import rank_device, spawn

    cfg = _config(device)
    n_tp = N_TP if n >= 4 and n % N_TP == 0 else 1
    dev = rank_device(device, 0)

    def one() -> tuple:
        dp = dp_steps(None, cfg, [make_tiny_batch(2 * n)], device=dev)
        if n_tp == 1:
            return dp, None
        return dp, dp_steps(None, cfg, [make_tiny_batch(2 * n // n_tp)], keep_params=1,
                            device=dev)

    ranks, (ref_dp, ref_tp) = _beside(lambda: spawn(_rank_steps, n, device, args=(cfg, n_tp)),
                                      one)
    _check_dp([r[0] for r in ranks], ref_dp, n, device)
    if n_tp == 1:
        return None
    tp = [r[1] for r in ranks]
    d = tp_distances(tp, ref_tp, n_tp)
    if not (d["equal"] and d["sliced"]):
        raise AssertionError(f"the dp x tp ranks' parameters differ or lost their slices: {d}")
    if max(d["loss"], d["norm"], d["param"]) > LOSS_TOL:
        raise AssertionError(f"the dp x tp step is {d} from one process's")
    m = tp[0]["metrics"][0]
    print(f"dryrun dp x tp ({n // n_tp} x {n_tp}) step OK on {device}: {d['tp_sharded_g']} "
          f"generator parameters tp-sharded; loss_gen_all {m['loss_gen_all']:.4f}, loss_disc "
          f"{m['loss_disc']:.4f}; losses within {d['loss']:.3g}, gradient norms {d['norm']:.3g}, "
          f"parameters {d['param']:.3g} of one process's step", flush=True)
    return {"ranks": tp, "one": ref_tp}


def _stage3(n: int, device: str) -> None:
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
    lsb = 0
    for (a, sr), (b, _), src in zip(one, split, songs):
        assert a.dtype == np.int16 and abs(len(a) - len(src) * sr // 16000) <= sr // 50
        assert int(np.abs(a.astype(np.int32)).max()) > 0
        if a.shape != b.shape:
            raise AssertionError("the split chunk batch's output has another length")
        lsb = max(lsb, int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()))
    if lsb > (0 if n <= 2 else SPLIT_LSB):
        raise AssertionError(f"the split chunk batch's int16 output is {lsb} LSB from one "
                             f"device's")
    print(f"dryrun inference OK over {devices}: {len(songs)} songs, int16 within {lsb} LSB of "
          f"one device's, outputs {[len(w) for w, _ in split]} samples at {split[0][1]} Hz",
          flush=True)


def run_dryrun(n_devices: int, device: str = "cuda") -> dict | None:
    """Stages 1 and 3 over ``n_devices`` ranks and devices: the cards
    (``cuda:0`` ... ``cuda:n-1``), or ``device="cpu"``'s processes; stage 2
    over the same ranks when there are four or more and an even count. More
    ranks than cards raises. Returns stage 2's results (``_stages_1_2``'s),
    None without it."""
    from .mesh import make_mesh

    make_mesh(n_devices, 2 * n_devices, device)
    t0 = time.perf_counter()
    tp = _stages_1_2(n_devices, device)
    _stage3(n_devices, device)
    print(f"[dryrun] all stages OK in {time.perf_counter() - t0:.1f} s", flush=True)
    return tp


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n-devices", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    a = p.parse_args(argv)
    run_dryrun(a.n_devices, a.device)


if __name__ == "__main__":
    main()
