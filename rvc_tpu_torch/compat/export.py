"""Serialized inference programs: ``Synthesizer.infer`` and ``infer_mix``
written out with ``torch.export``.

Counterpart of ``rvc_tpu/compat/export.py`` (``jax.export`` to StableHLO),
itself the JAX package's form of the reference's ONNX export
(models_onnx.py:530-628). The program is traced at JAX's static shapes on
the module's own device and in its compute dtype, under ``torch.no_grad()``
(the inference route of every layer), and saved with ``torch.export.save``.
The kernels stay in it: each forward-only kernel wrapper reaches its kernel
through a custom op of the ``rvc`` namespace (``ops.resblock``,
``ops.attention``, ``ops.retrieval``), so an exported program traced on the
card launches kernels 1 and 2 (8 or kernel 4's forward with
``fuse_group=False``) when it runs, and the plain versions on the CPU.

JAX's program takes a PRNG key; this one takes the draws themselves: ``eps``
(B, inter, T), the prior's standard normal in the compute dtype, and with f0
the sine source's ``rand_ini`` (B, harmonics) uniform and ``noise`` (B, T
upp, harmonics) standard normal, in float32. ``load_exported`` gives back a
callable that draws them from a ``torch.Generator`` in the eager call's
order, so the same seed gives the eager ``infer``'s output.

    blob = export_infer(synth, feature_dim=768)     # bytes
    fn = load_exported(blob)
    wav = fn(phone, lengths, pitch, nsff0, sid, generator=torch.Generator("cuda").manual_seed(0))

This module imports no model: a process that loads a blob needs only the
ops' definitions.
"""
from __future__ import annotations

import io

import torch


class _Infer(torch.nn.Module):
    """``synth.infer`` (or ``infer_mix``) with its draws as inputs,
    returning the waveform (B, T upp)."""

    def __init__(self, synth: torch.nn.Module, mix: bool):
        super().__init__()
        self.synth = synth
        self.mix = mix

    def forward(self, phone, lengths, pitch, nsff0, sid_or_mix, eps, rand_ini=None,
                noise=None):
        run = self.synth.infer_mix if self.mix else self.synth.infer
        if not self.synth.use_f0:  # the no-f0 synthesizer reads neither
            pitch = nsff0 = None
        sine = {} if rand_ini is None else dict(rand_ini=rand_ini, noise=noise)
        o, _, _ = run(phone, lengths, pitch, nsff0, sid_or_mix, eps=eps, **sine)
        return o[:, 0, :]


def export_program(synth, feature_dim: int, max_frames: int = 2048, batch: int = 1,
                   mix: bool = False) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` of ``synth.infer`` (``infer_mix`` with
    ``mix``) at the static shapes of ``export_infer``, unsaved."""
    dev = next(synth.parameters()).device
    B, T = batch, max_frames
    ids = dict(dtype=torch.long, device=dev)
    who = (torch.ones(B, synth.emb_g.num_embeddings, device=dev) if mix
           else torch.zeros(B, **ids))
    args = [torch.zeros(B, T, feature_dim, device=dev), torch.full((B,), T, **ids),
            torch.ones(B, T, **ids), torch.full((B, T), 150.0, device=dev), who,
            torch.zeros(B, synth.enc_p.out_channels, T, device=dev, dtype=synth.dtype)]
    if synth.use_f0:
        source = synth.dec.m_source
        dim = source.harmonic_num + 1
        args += [torch.zeros(B, dim, device=dev), torch.zeros(B, T * synth.dec.upp, dim,
                                                               device=dev)]
    with torch.no_grad():
        return torch.export.export(_Infer(synth, mix).eval(), tuple(args), strict=False)


def program_bytes(program: torch.export.ExportedProgram) -> bytes:
    """``torch.export.save`` of ``program`` into bytes."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_infer(synth, feature_dim: int, max_frames: int = 2048, batch: int = 1) -> bytes:
    """``synth.infer`` as a saved ``torch.export`` program: inputs phone (B,
    max_frames, feature_dim) float32, lengths (B,), pitch (B, max_frames)
    and sid (B,) int64, nsff0 (B, max_frames) float32, then the draws
    (module docstring); output o[:, 0, :] (B, max_frames upp) in the
    compute dtype."""
    return program_bytes(export_program(synth, feature_dim, max_frames, batch))


def export_infer_mix(synth, feature_dim: int, max_frames: int = 2048, batch: int = 1) -> bytes:
    """``synth.infer_mix`` as ``export_infer`` writes ``infer``: a (B,
    spk_embed_dim) float32 speaker weight map in place of sid."""
    return program_bytes(export_program(synth, feature_dim, max_frames, batch, mix=True))


def rvc_ops(program: torch.export.ExportedProgram) -> dict:
    """{op name: count} of the ``rvc`` custom ops in a program's graph."""
    out: dict = {}
    for n in program.graph.nodes:
        name = getattr(n.target, "name", lambda: "")()
        if n.op == "call_function" and name.startswith("rvc::"):
            out[name] = out.get(name, 0) + 1
    return out


def load_exported(blob: bytes):
    """A saved program of ``export_infer`` / ``export_infer_mix`` as
    ``fn(phone, lengths, pitch, nsff0, sid_or_mix, generator=None)``: it
    draws eps, then rand_ini and noise (with f0) from ``generator`` (the
    default generator of the program's device when None) at the program's
    shapes, dtypes and device, and runs the program without gradients.
    ``fn.program`` is the loaded ``ExportedProgram``."""
    from ..ops import attention, resblock, retrieval  # noqa: F401  the rvc ops it calls

    program = torch.export.load(io.BytesIO(blob))
    module = program.module()
    vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    draws = [(name, vals[name]) for name in program.graph_signature.user_inputs[5:]]

    def fn(phone, lengths, pitch, nsff0, sid_or_mix, generator=None):
        made = [(torch.rand if name == "rand_ini" else torch.randn)(
            tuple(v.shape), generator=generator, device=v.device, dtype=v.dtype)
            for name, v in draws]
        with torch.no_grad():
            return module(phone, lengths, pitch, nsff0, sid_or_mix, *made)

    fn.program = program
    return fn
