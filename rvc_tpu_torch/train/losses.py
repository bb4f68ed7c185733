"""GAN and reconstruction losses of the training step.

Counterpart of ``rvc_tpu/train/losses.py:30-75`` (the reference's
lib/train/losses.py): LSGAN discriminator and generator losses, feature
matching, the VITS prior KL and the mel L1, all reduced in float32.
``combined_aux_loss`` is ported in the form the default weights reach
(``c_hd = c_tsi = c_tefs = 0``): three zeros. The HPSS, TSI and TEFS terms
and ``MultiScaleMelLoss`` are not ported yet (ROADMAP).
"""
from __future__ import annotations

import torch


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss


def discriminator_loss(disc_real, disc_gen):
    loss, per_disc = 0.0, []
    for dr, dg in zip(disc_real, disc_gen):
        part = torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
        per_disc.append(part)
        loss = loss + part
    return loss, per_disc


def generator_loss(disc_gen):
    loss, per_disc = 0.0, []
    for dg in disc_gen:
        part = torch.mean((1.0 - dg.float()) ** 2)
        per_disc.append(part)
        loss = loss + part
    return loss, per_disc


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask) -> torch.Tensor:
    """VITS prior KL; tensors (B, C, T), mask (B, 1, T). The numerator sums
    over channels, the denominator counts each valid frame once."""
    z_p, logs_q, m_p, logs_p = (t.float() for t in (z_p, logs_q, m_p, logs_p))
    m = z_mask.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * m) / torch.sum(m)


def mel_l1(y_mel, y_hat_mel) -> torch.Tensor:
    return torch.mean(torch.abs(y_mel.float() - y_hat_mel.float()))


def combined_aux_loss(original_audio, generated_audio, c_tefs: float = 0.0,
                      c_hd: float = 0.0, c_tsi: float = 0.0):
    """(harmonic, tefs, tsi) losses at their default weights of 0: zeros."""
    if c_tefs or c_hd or c_tsi:
        raise NotImplementedError("the HPSS/TSI/TEFS aux losses are not ported yet")
    zero = generated_audio.new_zeros(())
    return zero, zero, zero
