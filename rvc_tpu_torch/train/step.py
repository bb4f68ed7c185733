"""The GAN training step of RVC: the entry point of training.

Counterpart of ``rvc_tpu/train/step.py`` (Trainer, TrainState, the
optimizers' math and ``lr_schedule``), itself the reference's
training_cli.py:374-602. One step:

  1. the generator's training forward, once (``Synthesizer.forward``; the
     no-f0 variants' without pitch);
  2. the discriminator's update on (real slice, generated slice detached):
     its LSGAN loss and, with ``c_gp > 0``, the gradient penalty (the
     discriminator's loss on a random real/generated interpolation,
     differentiated with respect to that input with a graph, so that the
     penalty on the gradient's norm trains through a double backward),
     both through the balancer;
  3. the generator's losses through the *updated* discriminator: LSGAN,
     feature matching, the mel loss (the L1 on the sliced target mel, or
     with ``use_multiscale`` the multi-scale mel loss on the waveforms,
     weight ``c_mel``), the prior KL over the posterior's mask, the
     harmonic, TSI and TEFS aux losses (weights ``c_hd``, ``c_tsi``,
     ``c_tefs``; not computed at 0), balanced; one backward into the
     generator;
  4. both updates are AdamW with optax's semantics: betas (0.8, 0.99),
     eps 1e-9, decoupled weight decay 0.01 on every parameter, the learning
     rate ``lr_schedule`` indexed by the update count before its increment.
     ``MultiTensorAdamW`` (the JAX ``GroupedAdamW``'s role) runs each update
     and the global gradient norm as a handful of multi-tensor operations
     over all of a model's tensors; ``AdamW``, a tensor at a time, is its
     plain version.

PyTorch keeps parameters in the modules, so a step updates the trainer's
generator and discriminator in place; ``TrainState`` carries what else the
JAX state carries (optimizer moments, step, balancer states). On the card,
the decoder's ResBlock1 chains run kernels 4 and 5 and the WN stacks of the
posterior encoder and the flow kernels 6 and 7 (in groups of 8 layers);
the text encoder's attention trains through its plain version, as the JAX
``Trainer``'s does; the losses add no kernel launch (the discriminator is
cuDNN and autograd-native, so the penalty's double backward needs no
second-order rule of a kernel). ``dtype`` is the compute dtype of the
generator and the discriminator, as the JAX ``Trainer``'s (float32, or
bfloat16, its dtype on an accelerator, rvc_tpu/train/step.py:291): in
bfloat16 the layers round as the conversion path's do
(``layers.set_dtype_``), the decoder's chains take the bf16 unit kernel
forward and kernels 4 and 5 at bf16(0.1) backward, the WN groups round x
between them, the losses, the penalty's interpolation and the generated
slice's mels are taken in float32; parameters, gradients and the AdamW
state stay float32. float32 math runs with TF32 off. ``Trainer.eval_loss``
is the JAX ``Trainer.eval_fn``: the generator forward without gradients and
the sliced mel L1. The JAX package's FlatAdamW and its TPU-layout split of
the small tensors (``GroupedAdamW``'s ``small_threshold``) are not ported.

``Trainer(world=)`` is the JAX step under its ``('dp',)`` mesh
(rvc_tpu/pipelines/train.py:85-158): every rank calls ``step`` with the
same *global* batch and draws (``draws`` draws on the global shape) and
computes on its own rows (``parallel.mesh.shard_batch``). Each loss is the
global batch's, made from the ranks' partial results: ``World.mean`` of
the batch means, the KL's masked sum and mask sum reduced apart, the aux
losses' min-max scaling over every rank's rows (``World.extrema``); so the
balancer sees what JAX's sees. The penalty's input gradient is that of the
global mean (the local loss over W). The parameter gradients are summed
over the ranks (``World.sum_grads``, one flat buffer a model) before the
norm and the update, so every rank's parameters stay equal. The metrics
are the global values; ``viz`` is rank 0's first sample, the batch's first.

``Trainer(mesh=)`` is the JAX step under its 2-D ``('dp', 'tp')`` mesh
(rvc_tpu/parallel/dryrun.py:204-237; ``parallel.mesh.make_mesh_2d``): the
batch's rows split over ``dp`` as above, within this rank's ``dp`` group
(``parallel.mesh.mesh_world``), and every parameter a ``DTensor`` placed by
``parallel.mesh.tp_param_spec`` (``init_state`` shards them). Each module
runs on its weights whole, gathered over ``tp`` (``parallel.mesh.gather_tp``,
what ``full_tensor()`` computes) and swapped in for the call
(``torch.func.functional_call``): the generator's once a step, the
discriminator's before its update and again after it; so weight norm folds
the whole ``(O, I, k)`` weight. The ``tp`` ranks of a ``dp`` group compute
the same rows and the same whole gradients, and the gather's backward keeps
this rank's slice of them (no sum over ``tp``, which would make it ``n_tp``
times too large), and a replicated parameter's gradient is averaged over
``tp``; then they are summed over ``dp``. The global gradient norm adds the
squares of the sharded slices over ``tp`` and counts each replicated
parameter once. AdamW updates the local slices, which stay sharded.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import RVCConfig
from ..device import mark as _mark, resolve_device, set_float32_math
from ..models.discriminator import MultiPeriodDiscriminator
from ..models.layers import (init_random_, live_weight_norm_, load_numpy_state_dict,
                             set_dtype_, slice_segments)
from ..models.synthesizer import Synthesizer
from ..models.wavenet import WN
from ..ops.mel import mel_spectrogram, spec_to_mel
from ..parallel.mesh import (gather_tp, mesh_world, shard_batch, shard_params_tp, tp_mean,
                             tp_sharded)
from . import balancer as bal
from . import losses as L

G_LOSS_KEYS = ("loss_gen", "loss_fm", "loss_mel", "loss_kl",
               "harmonic_loss", "tsi_loss", "tefs_loss")
D_LOSS_KEYS = ("loss_disc", "gradient_penalty")


def lr_schedule(base_lr: float, lr_decay: float, steps_per_epoch: int):
    """Per-epoch exponential decay (the reference's ExponentialLR)."""
    def fn(step: int) -> float:
        return base_lr * (lr_decay ** (step // max(steps_per_epoch, 1)))

    return fn


class AdamW:
    """optax.adamw over a list of parameters, updated in place a tensor at a
    time: the plain version of ``MultiTensorAdamW``, with the same state
    (``m``, ``v``, ``count``) and interface."""

    def __init__(self, params, schedule, betas=(0.8, 0.99), eps=1e-9, weight_decay=0.01):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def _advance(self) -> tuple[float, float, float]:
        """The learning rate from the count before its increment, the bias
        corrections from the count after it (optax's order)."""
        lr = self.schedule(self.count)
        self.count += 1
        return lr, 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """One update; returns the global norm of ``grads``."""
        norm = _global_norm(grads)
        lr, bc1, bc2 = self._advance()
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps) + self.wd * p
            p.sub_(lr * update)
        return norm


class MultiTensorAdamW(AdamW):
    """The same update over all tensors at once, through ``torch._foreach_*``
    (on the card a few launches an operation, each over many tensors, where
    ``AdamW`` launches a few per tensor), and the global gradient norm from
    the per-tensor norms of one multi-tensor reduction, as the JAX
    ``GroupedAdamW.apply_with_norm`` takes it from the buffers the update
    touches (rvc_tpu/train/step.py:117-236)."""

    @torch.no_grad()
    def step(self, grads, norm: torch.Tensor | None = None) -> torch.Tensor:
        """One update; returns the global norm of ``grads``, or ``norm`` when
        the caller gives it (a tp-sharded model's, which its local slices
        alone do not give)."""
        grads = list(grads)
        if norm is None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        lr, bc1, bc2 = self._advance()
        torch._foreach_mul_(self.m, self.b1)
        torch._foreach_add_(self.m, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.v, self.b2)
        torch._foreach_addcmul_(self.v, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_div(self.v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.m, bc1)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, self.params, alpha=self.wd)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(self.params, update)
        return norm


class TrainState(NamedTuple):
    opt_g: AdamW
    opt_d: AdamW
    step: int
    balancer_g: bal.BalancerState
    balancer_d: bal.BalancerState


def _grads(total: torch.Tensor, params: list) -> list:
    """d total / d params, zeros where a parameter is not reached."""
    grads = torch.autograd.grad(total, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _global_norm(grads: list) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


class Trainer:
    """The generator (``synth``) and discriminator (``disc``) of one
    configuration on one device, computing in ``dtype``, and the GAN step
    over them."""

    def __init__(self, config: RVCConfig, dtype: torch.dtype = torch.float32,
                 balancer_active: bool = True, device=None, world=None, mesh=None):
        """``world`` (``parallel.mesh.World``): this rank's share of a
        data-parallel step, computed on ``world.device``. ``mesh`` (a
        ``parallel.mesh.make_mesh_2d`` mesh): this rank's share of the dp x
        tp step (module docstring), computed on ``device``."""
        from ..pipelines.convert import synth_kwargs_from_config

        if mesh is not None:
            world = mesh_world(mesh, resolve_device(device))
        self.mesh = mesh
        self.world = world
        self.device = world.device if world is not None else resolve_device(device)
        set_float32_math()
        t = config.train
        self.config = config
        self.dtype = dtype
        self.balancer_active = balancer_active
        self.synth = live_weight_norm_(Synthesizer(**synth_kwargs_from_config(config),
                                                   posterior=True, dtype=dtype))
        for m in self.synth.modules():  # as the JAX Trainer's fuse_wn: eval_loss runs it too
            if isinstance(m, WN):
                m.fuse = True
        self.disc = set_dtype_(MultiPeriodDiscriminator(config.model.version,
                                                        scale=config.model.disc_scale), dtype)
        self.synth.to(self.device)
        self.disc.to(self.device)
        self.seg_frames = t.segment_size // config.data.hop_length
        self.g_initial = torch.tensor([1.0, 1.0, t.c_mel, t.c_kl, t.c_hd, t.c_tsi, t.c_tefs],
                                      device=self.device)
        self.d_initial = torch.tensor([1.0, 1.0 if t.c_gp > 0 else 0.0], device=self.device)
        self.msml: L.MultiScaleMelLoss | None = None  # set by use_multiscale
        self.grads: dict | None = None  # the last step's, when it was asked to keep them

    def use_multiscale(self, **kwargs) -> None:
        """The mel loss becomes ``losses.MultiScaleMelLoss`` at the data's
        sampling rate (``kwargs`` its own) on the waveforms, in float32."""
        self.msml = L.MultiScaleMelLoss(self.config.data.sampling_rate, **kwargs)

    def init_state(self, seed: int = 0, steps_per_epoch: int = 100,
                   state_g: dict | None = None, state_d: dict | None = None) -> TrainState:
        """Random weights from ``seed`` (the generator's) and ``seed + 1``
        (the discriminator's), drawn as the JAX package's fast_init draws
        them, unless reference-named state_dicts of numpy arrays are given
        (``compat.weights.synthesizer_state_dict(params, fold=False)`` and
        ``discriminator_state_dict``)."""
        for module, state, s in ((self.synth, state_g, seed), (self.disc, state_d, seed + 1)):
            if state is None:
                init_random_(module, s)
            else:
                load_numpy_state_dict(module, state)
        if self.mesh is not None:
            shard_params_tp(self.mesh, (self.synth, self.disc))
        t = self.config.train
        sched = self.schedule = lr_schedule(t.learning_rate, t.lr_decay, steps_per_epoch)
        return TrainState(
            opt_g=MultiTensorAdamW(self._shards(self.synth), sched, tuple(t.betas), t.eps),
            opt_d=MultiTensorAdamW(self._shards(self.disc), sched, tuple(t.betas), t.eps),
            step=0,
            balancer_g=bal.init_state(len(G_LOSS_KEYS), self.device),
            balancer_d=bal.init_state(len(D_LOSS_KEYS), self.device))

    def draws(self, batch: dict, seed: int) -> dict:
        """The step's random draws from a CPU generator seeded with
        ``seed``, so that every device draws the same, in the JAX step's
        order: the posterior sample's normal, the segment starts' uniform,
        with f0 the sine source's start phase and noise, and with
        ``c_gp > 0`` the penalty's interpolation weight ``alpha`` (B, 1, 1)."""
        gen = torch.Generator().manual_seed(seed)
        B, T = np.shape(batch["spec"])[:2]
        inter = self.synth.enc_p.out_channels
        out = dict(eps_q=torch.randn(B, inter, T, generator=gen),
                   u_slice=torch.rand(B, generator=gen))
        if self.synth.use_f0:
            out["rand_ini"] = torch.rand(B, 1, generator=gen)
            out["noise"] = torch.randn(B, self.seg_frames * self.synth.dec.upp, 1,
                                       generator=gen)
        if self.config.train.c_gp > 0:
            out["alpha"] = torch.rand(B, 1, 1, generator=gen)
        return {k: v.to(self.device) for k, v in out.items()}

    def _forward(self, b: dict, draws: dict, full: dict | None = None):
        """The generator's training forward on a batch of tensors, without
        or with pitch, the draws other than ``alpha``; on the weights
        ``full`` under a mesh (``_gathered``)."""
        return self._call(self.synth, full, b["phone"], b["phone_lengths"], b.get("pitch"),
                          b.get("pitchf"), b["spec"], b["spec_lengths"], b["sid"],
                          **{k: v for k, v in draws.items() if k != "alpha"})

    @staticmethod
    def _call(module, full: dict | None, *args, **kwargs):
        """``module(*args, **kwargs)``, on the weights ``full`` when given."""
        if full is None:
            return module(*args, **kwargs)
        return torch.func.functional_call(module, full, args, kwargs)

    def _gathered(self, module) -> dict | None:
        """Under a mesh, the module's weights whole by name (each parameter
        through ``parallel.mesh.gather_tp``: an all-gather over tp of a
        sharded one, differentiable); None without one."""
        if self.mesh is None:
            return None
        names, params = zip(*module.named_parameters())
        return dict(zip(names, gather_tp(list(params))))

    def _shards(self, module) -> list:
        """The tensors AdamW updates: the module's parameters, or under a mesh
        their local slices (views of the DTensors' local tensors)."""
        if self.mesh is None:
            return list(module.parameters())
        with torch.no_grad():
            return [p.to_local() for p in module.parameters()]

    def _param_grads(self, total: torch.Tensor, module, opt) -> list:
        """d total / d the module's parameters, in the order of
        ``opt.params``: under a mesh this rank's slices (see the module
        docstring), each replicated parameter's gradient the mean of the tp
        ranks' (the same value up to rounding: on the card cuDNN's free
        engines give each process its own bits, and the replicated
        parameters must stay equal on every rank)."""
        if self.mesh is None:
            return _grads(total, opt.params)
        params = list(module.parameters())
        grads = [g.to_local() for g in _grads(total, params)]
        rep = [i for i, p in enumerate(params) if not tp_sharded(p)]
        for i, g in zip(rep, tp_mean(self.mesh, [grads[i] for i in rep])):
            grads[i] = g
        return grads

    @torch.no_grad()
    def _tp_norm(self, grads: list, module) -> torch.Tensor | None:
        """Under a mesh, the global norm of the module's gradients from this
        rank's slices (summed over dp already): the squares of the sharded
        slices summed over tp, each replicated parameter's counted once.
        None without a mesh."""
        if self.mesh is None:
            return None
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        sharded = torch.tensor([tp_sharded(p) for p in module.parameters()], device=sq.device)
        part = sq[sharded].sum()
        torch.distributed.all_reduce(part, group=self.mesh.get_group("tp"))
        return torch.sqrt(part + sq[~sharded].sum())

    def _tp_mark(self, events: list | None, name: str) -> None:
        if self.mesh is not None:
            _mark(events, name)

    def _tensors(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.tensor(np.asarray(v), device=self.device)
            out[k] = t.long() if k in ("pitch", "sid") or k.endswith("lengths") else t.float()
        return out

    def _mels(self, b: dict, y_hat: torch.Tensor, ids_slice: torch.Tensor):
        """(the target mel at the generated slice, the generated slice's mel
        taken in float32), each (B, n_mels, frames)."""
        d = self.config.data
        mel = spec_to_mel(b["spec"], d.filter_length, d.n_mel_channels, d.sampling_rate,
                          d.mel_fmin, d.mel_fmax)
        y_mel = slice_segments(mel.transpose(1, 2), ids_slice, self.seg_frames)
        y_hat_mel = mel_spectrogram(y_hat[:, 0].float(), d.filter_length, d.n_mel_channels,
                                    d.sampling_rate, d.hop_length, d.win_length, d.mel_fmin,
                                    d.mel_fmax).transpose(1, 2)
        return y_mel, y_hat_mel

    @torch.no_grad()
    def eval_loss(self, batch: dict, draws: dict | None = None) -> torch.Tensor:
        """Held-out evaluation (the JAX ``Trainer.eval_fn``): the generator's
        training forward without gradients, then the mel L1 on its slice.
        ``draws`` as ``step`` takes them (seeded with 0 when absent)."""
        if draws is None:
            draws = self.draws(batch, 0)
        batch, draws = self._local(batch, draws)
        b = self._tensors(batch)
        y_hat, ids_slice, *_ = self._forward(b, draws, self._gathered(self.synth))
        return self._global(L.mel_l1(*self._mels(b, y_hat, ids_slice)))

    def _local(self, batch: dict, draws: dict) -> tuple[dict, dict]:
        """This rank's rows of a global batch and its draws (all of them
        without a world)."""
        if self.world is None:
            return batch, draws
        rows = self.world.rows(len(batch["spec"]))
        return shard_batch(batch, self.world), {k: v[rows] for k, v in draws.items()}

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """A batch mean (or a stack of them) over the global batch."""
        return x if self.world is None else self.world.mean(x)

    def step(self, state: TrainState, batch: dict, draws: dict | None = None,
             keep_grads: bool = False, events: list | None = None):
        """One GAN step on a batch of ``train.data.BucketBatcher`` (numpy,
        the JAX keys and layouts). ``draws`` as ``Trainer.draws`` gives them
        (seeded with the step number when absent). Updates ``synth`` and
        ``disc`` in place; returns (new state, metrics as 0-d tensors, and
        under ``"viz"`` the first sample's target and generated mel and
        waveform slices). With
        ``keep_grads`` the step's gradients stay in ``self.grads`` ({"g": ...,
        "d": ...}, in the order of ``named_parameters``). On the card, a list
        given as ``events`` gets (stage, CUDA event) pairs: the first marks
        the start, each later one the end of the stage it names."""
        cfg, d = self.config, self.config.data
        t = cfg.train
        if draws is None:
            draws = self.draws(batch, state.step)
        batch, draws = self._local(batch, draws)
        b = self._tensors(batch)
        _mark(events, "start")
        full_g = self._gathered(self.synth)
        self._tp_mark(events, "generator tp gather")
        y_hat, ids_slice, x_mask, z_mask, (z, z_p, m_p, logs_p, m_q, logs_q) = self._forward(
            b, draws, full_g)
        wave_seg = slice_segments(b["wave"][:, None], ids_slice * d.hop_length, t.segment_size)
        # with the multi-scale loss the sliced mel L1 is not a loss: its
        # generated mel is only logged
        y_mel, y_hat_mel = self._mels(b, y_hat if self.msml is None else y_hat.detach(),
                                      ids_slice)
        _mark(events, "generator forward")

        # the discriminator's update, the generated slice detached
        fake = y_hat.detach()
        full_d = self._gathered(self.disc)
        self._tp_mark(events, "discriminator tp gather")
        y_d_r, y_d_g, _, _ = self._call(self.disc, full_d, wave_seg, fake)
        loss_disc, _ = L.discriminator_loss(y_d_r, y_d_g)
        if t.c_gp > 0:
            # the penalty on a random real/generated interpolation, in
            # float32 as JAX's type promotion gives it
            alpha = draws["alpha"]
            interp = (alpha * wave_seg + (1.0 - alpha) * fake).requires_grad_()
            loss_interp, _ = L.discriminator_loss(*self._call(self.disc, full_d, wave_seg,
                                                              interp)[:2])
            if self.world is not None:  # the input gradient of the global batch mean
                loss_interp = loss_interp / self.world.size
            (grad_x,) = torch.autograd.grad(loss_interp, interp, create_graph=True)
            gnorm = torch.sqrt(torch.sum(grad_x.reshape(grad_x.shape[0], -1) ** 2, -1) + 1e-12)
            gp = torch.mean((gnorm - 1.0) ** 2) * t.c_gp
        else:
            gp = torch.zeros_like(loss_disc)
        d_losses = self._global(torch.stack([loss_disc, gp]))
        loss_disc = d_losses[0]
        loss_d_all, new_bd, _ = bal.balance(state.balancer_d, d_losses, self.d_initial,
                                            active=self.balancer_active)
        d_grads = self._param_grads(loss_d_all, self.disc, state.opt_d)
        _mark(events, "discriminator forward and backward")
        if self.world is not None:
            d_grads = self.world.sum_grads(d_grads)
            _mark(events, "discriminator all-reduce")
        norm_d = self._tp_norm(d_grads, self.disc)
        self._tp_mark(events, "discriminator tp norm")
        grad_norm_d = state.opt_d.step(d_grads, norm_d)
        _mark(events, "discriminator update")

        # the generator's losses through the updated discriminator
        full_d = self._gathered(self.disc)
        self._tp_mark(events, "updated discriminator tp gather")
        y_d_r, y_d_g, fmap_r, fmap_g = self._call(self.disc, full_d, wave_seg, y_hat)
        if self.msml is None:
            loss_mel = L.mel_l1(y_mel, y_hat_mel)
        else:
            loss_mel = self.msml(y_hat[:, 0].float(), wave_seg[:, 0].float())
        loss_kl = L.kl_loss(z_p, logs_q, m_p, logs_p, z_mask, world=self.world)
        loss_fm = L.feature_loss(fmap_r, fmap_g)
        loss_gen, _ = L.generator_loss(y_d_g)
        harmonic, tefs, tsi = L.combined_aux_loss(
            wave_seg[:, 0].float(), y_hat[:, 0].float(), c_tefs=t.c_tefs, c_hd=t.c_hd,
            c_tsi=t.c_tsi, n_mels=d.n_mel_channels, sample_rate=d.sampling_rate,
            n_fft=d.filter_length, hop_length=d.hop_length, win_length=d.win_length,
            fmin=d.mel_fmin, fmax=d.mel_fmax, eps=t.eps, world=self.world)
        means = self._global(torch.stack([loss_gen, loss_fm, loss_mel, harmonic, tsi, tefs]))
        loss_gen, loss_fm, loss_mel, harmonic, tsi, tefs = means.unbind()
        loss_g_all, new_bg, _ = bal.balance(
            state.balancer_g,
            torch.stack([loss_gen, loss_fm, loss_mel, loss_kl, harmonic, tsi, tefs]),
            self.g_initial, active=self.balancer_active)
        _mark(events, "generator losses")
        g_grads = self._param_grads(loss_g_all, self.synth, state.opt_g)
        _mark(events, "generator backward")
        if self.world is not None:
            g_grads = self.world.sum_grads(g_grads)
            _mark(events, "generator all-reduce")
        norm_g = self._tp_norm(g_grads, self.synth)
        self._tp_mark(events, "generator tp norm")
        grad_norm_g = state.opt_g.step(g_grads, norm_g)
        _mark(events, "generator update")

        if keep_grads:
            self.grads = {"g": g_grads, "d": d_grads}
        metrics = {"loss_disc": loss_disc, "loss_disc_all": loss_d_all,
                   "grad_norm_g": grad_norm_g, "grad_norm_d": grad_norm_d,
                   "loss_gen": loss_gen, "loss_fm": loss_fm, "loss_mel": loss_mel,
                   "loss_kl": loss_kl, "harmonic_loss": harmonic, "tsi_loss": tsi,
                   "tefs_loss": tefs, "loss_gen_all": loss_g_all}
        metrics = {k: v.detach() for k, v in metrics.items()}
        # the first sample's slices, for the logged images and audio: device
        # tensors, downloaded only on a log step
        metrics["viz"] = {"y_mel": y_mel[0].detach(), "y_hat_mel": y_hat_mel[0].detach(),
                          "wave_org": wave_seg[0, 0], "wave_gen": y_hat[0, 0].detach().float()}
        return state._replace(step=state.step + 1, balancer_g=new_bg, balancer_d=new_bd), metrics
