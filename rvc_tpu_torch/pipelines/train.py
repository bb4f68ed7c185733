"""The training run: epochs of GAN steps, checkpoints, best model, export.

Counterpart of ``rvc_tpu/pipelines/train.py`` (``TrainRunConfig``,
``train_model``, ``_export``; the reference's training_cli.py:88-755), on
one device. Per epoch: length-bucketed batches of static shapes
(``train.data.BucketBatcher``) -> ``Trainer.step`` -> scalars (and on log
steps the mel images and audio) to TensorBoard when ``tensorboardX`` is
installed -> a training checkpoint every ``save_every_epoch`` epochs and at
the last -> best-model tracking in ``losses.json`` on the epoch's mean mel
L1 (held-out when ``eval_every_n`` > 1) with a ``_best`` export -> the final
fp16 ``.pth`` in the reference's inference format.

Each step's random draws come from ``Trainer.draws(batch, global_step)``,
so a run resumed from a checkpoint draws what an uninterrupted one would.
The JAX package's device mesh is one device here: ``n_devices`` may be None
or 1.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np

from ..config import RVCConfig
from ..train.checkpoints import (latest_checkpoint, restore_train_state, save_train_state,
                                 warm_start_)
from ..train.data import BucketBatcher, RVCDataset
from ..train.step import Trainer
from ..train.summaries import plot_spectrogram_to_numpy, summarize


@dataclass
class TrainRunConfig:
    model_dir: str
    filelist: str
    total_epochs: int = 100
    save_every_epoch: int = 10
    log_interval: int = 200
    n_devices: int | None = None
    pretrained_g: str | None = None
    pretrained_d: str | None = None
    export_name: str = "model"
    balancer_active: bool = True
    use_multiscale: bool = False  # the multi-scale mel loss in place of the sliced mel L1
    log_media: bool = True  # TensorBoard mel images and audio on log steps
    eval_every_n: int = 0  # hold out every n-th utterance (0: no evaluation)
    device: str | None = None  # the card unless "cpu" is asked for


def _writer(model_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(os.path.join(model_dir, "logs"))


def _log(writer, trainer: Trainer, run: TrainRunConfig, metrics: dict, step: int) -> None:
    viz = metrics.get("viz", {})
    scalars = {f"loss/{k}": float(v) for k, v in metrics.items() if k != "viz"}
    scalars["learning_rate"] = trainer.schedule(step)
    images = audios = None
    if run.log_media and viz:
        # reference training_cli.py:639-655: the target and generated mel,
        # their squared difference, the original and generated audio
        y_mel = viz["y_mel"].float().cpu().numpy()
        y_hat_mel = viz["y_hat_mel"].float().cpu().numpy()
        images = {"slice/mel_org": plot_spectrogram_to_numpy(y_mel),
                  "slice/mel_gen": plot_spectrogram_to_numpy(y_hat_mel),
                  "slice/diff^2": plot_spectrogram_to_numpy((y_mel - y_hat_mel) ** 2,
                                                            cmap="hot")}
        audios = {"slice/wave_org": viz["wave_org"].float().cpu().numpy(),
                  "slice/wave_gen": viz["wave_gen"].float().cpu().numpy()}
    summarize(writer, step, scalars=scalars, images=images, audios=audios,
              audio_sampling_rate=trainer.config.data.sampling_rate)


def train_model(config: RVCConfig, run: TrainRunConfig) -> str:
    """Runs the training loop; returns the exported ``.pth`` path."""
    if run.n_devices not in (None, 1):
        raise NotImplementedError("training on several cards (DDP) is not ported yet")
    os.makedirs(run.model_dir, exist_ok=True)
    writer = _writer(run.model_dir)

    train_list: str | list[str] = run.filelist
    eval_batcher = None
    if run.eval_every_n > 1:
        with open(run.filelist, encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        eval_lines = lines[:: run.eval_every_n]
        train_lines = [ln for i, ln in enumerate(lines) if i % run.eval_every_n != 0]
        if train_lines and eval_lines:
            train_list = train_lines
            eval_batcher = BucketBatcher(RVCDataset(eval_lines, config.data,
                                                    use_f0=config.model.use_f0),
                                         config.train.batch_size, seed=config.train.seed)

    dataset = RVCDataset(train_list, config.data, use_f0=config.model.use_f0)
    batcher = BucketBatcher(dataset, config.train.batch_size, seed=config.train.seed)
    steps_per_epoch = max(1, sum(len(v) // config.train.batch_size
                                 for v in batcher.buckets.values()))
    trainer = Trainer(config, balancer_active=run.balancer_active, device=run.device)
    if run.use_multiscale:
        trainer.use_multiscale()
    state = trainer.init_state(seed=config.train.seed, steps_per_epoch=steps_per_epoch)

    # resume, or a warm start
    ckpt = latest_checkpoint(run.model_dir)
    start_epoch = 0
    if ckpt is not None:
        state = restore_train_state(ckpt, trainer, state)
        start_epoch = state.step // steps_per_epoch
        print(f"resumed {ckpt} at epoch {start_epoch}")
    else:
        if run.pretrained_g:
            warm_start_(trainer.synth, run.pretrained_g)
        if run.pretrained_d:
            warm_start_(trainer.disc, run.pretrained_d)

    best = {"loss": float("inf"), "epoch": -1}
    losses_path = os.path.join(run.model_dir, "losses.json")
    if os.path.exists(losses_path):
        with open(losses_path) as f:
            best.update(json.load(f))

    global_step = state.step
    for epoch in range(start_epoch, run.total_epochs):
        t0 = time.time()
        epoch_mel = []  # device tensors, read once the epoch is over
        for batch in batcher.epoch(epoch):
            state, metrics = trainer.step(state, batch, draws=trainer.draws(batch, global_step))
            global_step += 1
            if writer and run.log_interval > 0 and global_step % run.log_interval == 0:
                _log(writer, trainer, run, metrics, global_step)
            epoch_mel.append(metrics["loss_mel"])
        epoch_mel = [float(v) for v in epoch_mel]
        mean_mel = float(np.mean(epoch_mel)) if epoch_mel else float("inf")
        if eval_batcher is not None:
            ev_losses = [float(trainer.eval_loss(batch, trainer.draws(batch, 0)))
                         for batch in eval_batcher.epoch(0)]  # a fixed order: comparable
            if ev_losses:
                mean_mel = float(np.mean(ev_losses))  # best-model tracking on held-out data
                if writer:
                    writer.add_scalar("eval/loss_mel", mean_mel, global_step)
        print(f"epoch {epoch}: {time.time() - t0:.1f}s, mel={mean_mel:.3f}")

        if (epoch + 1) % run.save_every_epoch == 0 or epoch + 1 == run.total_epochs:
            save_train_state(run.model_dir, trainer, state, global_step)
        if mean_mel < best["loss"]:
            best = {"loss": mean_mel, "epoch": epoch}
            with open(losses_path, "w") as f:
                json.dump(best, f)
            _export(config, trainer, run, suffix="_best")

    if writer:
        writer.close()
    return _export(config, trainer, run, suffix="")


def _export(config: RVCConfig, trainer: Trainer, run: TrainRunConfig, suffix: str = "") -> str:
    """The generator as the reference's inference ``.pth``, with its
    positional ``config`` list."""
    from ..compat.torch_export import save_rvc_checkpoint

    d, m, t = config.data, config.model, config.train
    cfg_list = [
        d.spec_channels, t.segment_size // d.hop_length, m.inter_channels,
        m.hidden_channels, m.filter_channels, m.n_heads, m.n_layers, m.kernel_size,
        m.p_dropout, m.resblock, list(m.resblock_kernel_sizes),
        [list(x) for x in m.resblock_dilation_sizes], list(m.upsample_rates),
        m.upsample_initial_channel, list(m.upsample_kernel_sizes), m.spk_embed_dim,
        m.gin_channels, d.sampling_rate,
    ]
    path = os.path.join(run.model_dir, f"{run.export_name}{suffix}.pth")
    save_rvc_checkpoint(path, trainer.synth, cfg_list, sr=d.sampling_rate, f0=int(m.use_f0),
                        version=m.version)
    return path
