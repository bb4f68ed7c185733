"""``rvc_tpu_torch.compat.export`` against eager and against
``rvc_tpu.compat.export``, and the ``rvc`` custom ops under
``torch.library.opcheck``.

At the tiny shapes of ``tests/test_compat_tools.py`` (its ``TINY``
synthesizer, 24 features, ``max_frames=8``): the port's exported ``infer``
and ``infer_mix`` round-trip through bytes and, with a seeded generator,
give the eager call's output bit for bit; fed the draws JAX's own apply
makes with the key given to JAX's exported call, they are within 1e-5 of
JAX's exported output; the graph holds the ``rvc`` ops; and a fresh process
that imports only ``compat.export`` runs a blob.
"""
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, one_thread, recorded_draws  # noqa: F401
from rvc_tpu.compat import export as jexport
from rvc_tpu.models import synthesizer as jsyn
from rvc_tpu_torch.compat import export as texport
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models.layers import load_numpy_state_dict
from rvc_tpu_torch.models.synthesizer import Synthesizer
from rvc_tpu_torch.ops import attention, resblock, retrieval

TINY = dict(spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=16,
            filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
            resblock="1", resblock_kernel_sizes=(3, 5),
            resblock_dilation_sizes=((1, 3), (1, 3)), upsample_rates=(10, 4, 2, 2),
            upsample_initial_channel=32, upsample_kernel_sizes=(16, 8, 4, 4),
            spk_embed_dim=4, gin_channels=8, sr=16000, feature_dim=24, use_f0=True)
B, T, FEAT = 1, 8, 24
BAR = 1e-5  # of the largest magnitude: float32 sums in another order
JIT_BAR = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def case():
    """JAX params (seeded), the port's synthesizer on them, and one input."""
    rng = np.random.default_rng(0)
    inputs = dict(phone=rng.standard_normal((B, T, FEAT)).astype(np.float32),
                  lengths=np.array([T - 1], np.int32),
                  pitch=rng.integers(1, 255, (B, T)).astype(np.int32),
                  nsff0=(rng.uniform(100, 300, (B, T)) * (rng.uniform(size=(B, T)) > 0.2)
                         ).astype(np.float32),
                  sid=np.array([2], np.int32),
                  mix=rng.uniform(0.1, 1.0, (B, 4)).astype(np.float32))
    j = jsyn.Synthesizer(**TINY)
    args = [jnp.asarray(inputs[k]) for k in ("phone", "lengths", "pitch", "nsff0", "sid")]
    params = finit(lambda *a: j.init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, *a, method=j.infer),
                   *args, seed=3)
    synth = load_numpy_state_dict(Synthesizer(**TINY), weights.synthesizer_state_dict(params))
    return j, params, synth.eval(), inputs


@pytest.fixture(scope="module")
def blobs(case):
    """The port's exported infer and infer_mix of ``case``'s synthesizer."""
    synth = case[2]
    return {False: texport.export_infer(synth, FEAT, max_frames=T),
            True: texport.export_infer_mix(synth, FEAT, max_frames=T)}


def _torch_inputs(inputs: dict, mix: bool) -> tuple:
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    who = t["mix"] if mix else t["sid"].long()
    return t["phone"], t["lengths"].long(), t["pitch"].long(), t["nsff0"], who


@pytest.mark.parametrize("mix", [False, True], ids=["infer", "infer_mix"])
def test_export_round_trip_equals_eager(case, blobs, mix):
    """Exported, saved to bytes, loaded: with a seeded generator the loaded
    callable gives the eager call's output bit for bit (the same draws in
    the same order), and the graph holds one rvc::resblock_group per decoder
    stage and one rvc::banded_rel_attention per encoder layer."""
    _, _, synth, inputs = case
    blob = blobs[mix]
    assert isinstance(blob, bytes)
    fn = texport.load_exported(blob)
    args = _torch_inputs(inputs, mix)
    got = fn(*args, generator=torch.Generator().manual_seed(5))
    run = synth.infer_mix if mix else synth.infer
    with torch.no_grad():
        ref = run(*args, generator=torch.Generator().manual_seed(5))[0][:, 0]
    assert got.shape == (B, T * synth.dec.upp)
    assert torch.equal(got, ref)
    ops = texport.rvc_ops(fn.program)
    assert ops == {"rvc::resblock_group": len(TINY["upsample_rates"]),
                   "rvc::banded_rel_attention": TINY["n_layers"]}


@pytest.mark.parametrize("mix", [False, True], ids=["infer", "infer_mix"])
def test_export_against_jax_export(case, blobs, monkeypatch, mix):
    """JAX's exported program agrees with its jit apply with the same key
    (within JIT_BAR of the largest magnitude: XLA fuses the two programs
    apart); the port's exported program, fed the draws that apply made
    (eps, rand_ini, noise), is within BAR of the largest magnitude of JAX's
    exported output."""
    j, params, synth, inputs = case
    who = inputs["mix"] if mix else inputs["sid"]
    jargs = [jnp.asarray(v) for v in (inputs["phone"], inputs["lengths"], inputs["pitch"],
                                      inputs["nsff0"], who)]
    key = jax.random.PRNGKey(7)
    export = jexport.export_infer_mix if mix else jexport.export_infer
    ref = np.asarray(jexport.load_exported(export(j, params, FEAT, max_frames=T))(*jargs, key))
    method = j.infer_mix if mix else j.infer
    apply = jax.jit(lambda p, *a: j.apply(p, *a, method=method, rngs={"noise": key}))
    with recorded_draws(monkeypatch) as draws:
        o = apply(params, *jargs)[0]
    jax.effects_barrier()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(o)[..., 0], ref, atol=JIT_BAR * scale, rtol=0)
    eps, rand_ini, noise = (torch.from_numpy(d) for d in draws)
    program = torch.export.load(io.BytesIO(blobs[mix])).module()
    with torch.no_grad():
        got = program(*_torch_inputs(inputs, mix), eps.transpose(1, 2), rand_ini, noise)
    print(f"{'infer_mix' if mix else 'infer'}: max |port - JAX| / max |JAX| "
          f"{np.abs(got.numpy() - ref).max() / scale:.3g}, JAX export vs jit "
          f"{np.abs(np.asarray(o)[..., 0] - ref).max() / scale:.3g}")
    np.testing.assert_allclose(got.numpy(), ref, atol=BAR * scale, rtol=0)


def test_export_graph_without_fuse_group(case):
    """With fuse_group=False each ResBlock is one rvc::resblock1 (kernel 4's
    forward on the card) and no rvc::resblock_group is left."""
    _, _, synth, _ = case
    synth.dec.fuse_group = False
    try:
        blob = texport.export_infer(synth, FEAT, max_frames=T)
    finally:
        synth.dec.fuse_group = True
    n_blocks = len(TINY["upsample_rates"]) * len(TINY["resblock_kernel_sizes"])
    assert texport.rvc_ops(torch.export.load(io.BytesIO(blob))) == {
        "rvc::resblock1": n_blocks, "rvc::banded_rel_attention": TINY["n_layers"]}


def test_exported_blob_runs_in_a_fresh_process(case, blobs, tmp_path):
    """A process that imports only rvc_tpu_torch.compat.export loads the
    blob and runs it, with the eager call's output; no model module is
    imported there."""
    _, _, synth, inputs = case
    (tmp_path / "infer.pt2").write_bytes(blobs[False])
    args = _torch_inputs(inputs, False)
    torch.save(args, tmp_path / "args.pt")
    code = (
        "import sys, torch\n"
        "from rvc_tpu_torch.compat.export import load_exported\n"
        f"d = {str(tmp_path)!r}\n"
        "fn = load_exported(open(d + '/infer.pt2', 'rb').read())\n"
        "out = fn(*torch.load(d + '/args.pt'), generator=torch.Generator().manual_seed(5))\n"
        "torch.save(out, d + '/out.pt')\n"
        "print(sorted(m for m in sys.modules if m.startswith('rvc_tpu_torch.models')))\n"
        "assert 'jax' not in sys.modules\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "rvc_tpu_torch.models.synthesizer" not in proc.stdout, proc.stdout
    with torch.no_grad():
        ref = synth.infer(*args, generator=torch.Generator().manual_seed(5))[0][:, 0]
    assert torch.equal(torch.load(tmp_path / "out.pt"), ref)


def _chain(rng, C: int, k: int, dilations) -> list:
    return [(torch.from_numpy(0.1 * rng.standard_normal((C, C, k)).astype(np.float32)),
             torch.from_numpy(0.1 * rng.standard_normal(C).astype(np.float32)), k, dd)
            for d in dilations for dd in (d, 1)]


def _op_cases():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 24, 16)).astype(np.float32))
    chains = [_chain(rng, 16, 3, (1, 3)), _chain(rng, 16, 5, (1, 2))]
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 12, 32)).astype(np.float32))
               for _ in range(3))
    ek, ev = (torch.from_numpy(rng.standard_normal((9, 32)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([12, 7])
    feats = torch.from_numpy(rng.standard_normal((10, 32)).astype(np.float32))
    bank = rng.standard_normal((40, 32)).astype(np.float32)
    bank_q, scales = retrieval.quantize_bank(bank)
    return {
        "resblock_group": (torch.ops.rvc.resblock_group, (x, *resblock._flat(chains))),
        "resblock_group_bf16": (torch.ops.rvc.resblock_group,
                                (x.bfloat16(), *resblock._flat(chains))),
        "resblock1": (torch.ops.rvc.resblock1, (x, *resblock._flat(chains[:1])[:4])),
        "resblock1_v2": (torch.ops.rvc.resblock1_v2,
                         (x.bfloat16(), *resblock._flat(chains[1:])[:4])),
        "banded_rel_attention": (torch.ops.rvc.banded_rel_attention,
                                 (q, k, v, ek, ev, lens, 4, 32 ** -0.5)),
        "banded_rel_attention_bf16": (torch.ops.rvc.banded_rel_attention,
                                      (q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                       ek.bfloat16(), ev.bfloat16(), lens, 4, 32 ** -0.5)),
        "nearest_rows": (torch.ops.rvc.nearest_rows, (feats, torch.from_numpy(bank), None)),
        "nearest_rows_q": (torch.ops.rvc.nearest_rows,
                           (feats, torch.from_numpy(bank_q), torch.from_numpy(scales))),
    }


@pytest.mark.parametrize("name", list(_op_cases()))
def test_op_opcheck_on_the_cpu(name):
    """torch.library.opcheck on each op's CPU implementation (the plain
    version): its schema, its registrations, and the fake implementation
    against the real one; and the op equals the wrapper's plain version."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
    got = op(*args)
    if name.startswith("resblock_group"):
        ref = resblock.resblock_group_plain(args[0], resblock._chains(*args[1:]))
    elif name.startswith("resblock1"):
        ref = resblock.fused_resblock1_plain(args[0], resblock._chains(*args[1:],
                                                                       [len(args[1])])[0])
    elif name.startswith("banded"):
        ref = attention.banded_rel_attention_plain(*args[:6], window=args[6], scale=args[7])
    else:
        bank = args[1].float() * (args[2] if args[2] is not None else 1.0)
        ref = retrieval.topk_blend(args[0], bank, 1)
    assert torch.equal(got, ref)
