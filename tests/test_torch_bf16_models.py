"""Each module of the conversion path in bfloat16 against its JAX module in
bfloat16, on the CPU, at tiny widths: the same float32 numpy weights (both
sides cast them at use), the same bf16-valued inputs, the JAX run's random
draws handed over.

Bars, fixed before the first run, relative to the tensor's largest
magnitude. Both sides round at the same points, but XLA and ATen sum in
other orders and XLA keeps excess precision inside fused element-wise
chains, so a rounding flips by a bf16 ulp now and then and the flips
travel through a deep module. So each output is held at the larger of
1e-2 of its largest magnitude (2.5 bf16 ulps there) and the JAX module's
own distance between its bf16 and float32 outputs on the same inputs
(bf16's own drift): the port in bf16 must be no farther from the JAX
module in bf16 than bf16 is from float32. Both distances are printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (finit, no_compile_cache_writes, recorded_draws,  # noqa: F401
                         replayed_draws)
from rvc_tpu.models import flows as jflows
from rvc_tpu.models import hubert as jhub
from rvc_tpu.models import layers as jlayers
from rvc_tpu.models import rmvpe as jrmvpe
from rvc_tpu.models import synthesizer as jsyn
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import flows as tflows
from rvc_tpu_torch.models import hubert as thub
from rvc_tpu_torch.models import layers as tlayers
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.models import synthesizer as tsyn

BF = torch.bfloat16
JBF = jnp.bfloat16
FLOOR = 1e-2


def T_(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def load(module, params, rename=weights.synthesizer_state_dict):
    m = tlayers.load_numpy_state_dict(module, rename(params)).eval()
    return tlayers.set_dtype_(m, BF)


def bf(a: np.ndarray) -> np.ndarray:
    """float32 numpy holding bf16 values (so both sides start from the same)."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float().numpy()


def rel_max(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


def held(what, got, ref_bf, ref_f32, transpose=False) -> None:
    """got (the port, bf16 torch) against ref_bf (JAX bf16), with the bar
    max(FLOOR, distance of ref_bf from ref_f32)."""
    got = got.detach().float().numpy()
    ref_bf, ref_f32 = (np.asarray(r, np.float32) for r in (ref_bf, ref_f32))
    if transpose:
        ref_bf, ref_f32 = np.swapaxes(ref_bf, 1, 2), np.swapaxes(ref_f32, 1, 2)
    port = rel_max(got, ref_bf)
    drift = rel_max(ref_bf, ref_f32)
    print(f"{what}: port bf16 vs JAX bf16 {port:.3g}, JAX bf16 vs JAX float32 {drift:.3g} "
          f"(of the largest magnitude)")
    assert np.all(np.isfinite(got))
    assert port <= max(FLOOR, drift), (what, port, drift)


def masks(B, T, lengths):
    m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return m[..., None], m[:, None, :]  # JAX (B, T, 1), port (B, 1, T)


def with_biases(rng, p):
    """fast_init zeroes every bias; give them values so the test sees them."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "bias" else a, p)


LAYERS = {
    "conv_dilated_wn": (lambda dt: jlayers.Conv1d(8, 16, 5, dilation=3, padding=6,
                                                  weight_norm=True, dtype=dt),
                        lambda: tlayers.Conv1d(8, 16, 5, dilation=3, padding=6), (2, 40, 8)),
    "conv_strided": (lambda dt: jlayers.Conv1d(1, 8, 8, stride=4, padding=2, dtype=dt),
                     lambda: tlayers.Conv1d(1, 8, 8, stride=4, padding=2), (2, 41, 1)),
    "conv_transpose_wn": (lambda dt: jlayers.ConvTranspose1d(12, 6, 8, stride=4, padding=2,
                                                             weight_norm=True, dtype=dt),
                          lambda: tlayers.ConvTranspose1d(12, 6, 8, stride=4, padding=2),
                          (2, 9, 12)),
    "layer_norm": (lambda dt: jlayers.LayerNorm(12, dtype=dt), lambda: tlayers.LayerNorm(12),
                   (2, 7, 12)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layers_bf16_match_jax(rng, case):
    """Channels-last JAX layers vs (B, C, T) port layers; the product
    rounded, then the bias added in bf16."""
    jmod, tmod, shape = LAYERS[case]
    x = bf(rng.standard_normal(shape))
    p = finit(lambda a: jmod(jnp.float32).init(jax.random.PRNGKey(0), a), jnp.asarray(x),
              seed=1)
    p = with_biases(rng, p)
    if case == "layer_norm":
        p = {"params": {"gamma": rng.uniform(0.5, 2, 12).astype(np.float32),
                        "beta": rng.standard_normal(12).astype(np.float32)}}
    refs = [jmod(dt).apply(p, jnp.asarray(x).astype(dt)) for dt in (JBF, jnp.float32)]
    got = load(tmod(), p)(T_(x).transpose(1, 2).to(BF))
    assert got.dtype == BF
    held(case, got, *refs, transpose=True)


def test_linear_and_embedding_bf16_match_jax(rng):
    x = bf(rng.standard_normal((2, 5, 12)))
    ids = rng.integers(0, 10, (2, 5))
    w = rng.standard_normal((7, 12)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    table = rng.standard_normal((10, 6)).astype(np.float32)
    lin = tlayers.set_dtype_(tlayers.Linear(12, 7), BF)
    emb = tlayers.set_dtype_(tlayers.Embedding(10, 6), BF)
    lin.load_state_dict({"weight": T_(w), "bias": T_(b)})
    emb.load_state_dict({"weight": T_(table)})
    for dt_name, refs in (("linear", [jlayers.Linear(12, 7, dtype=dt).apply(
            {"params": {"weight": w, "bias": b}}, jnp.asarray(x).astype(dt))
            for dt in (JBF, jnp.float32)]),
            ("embedding", [jlayers.Embedding(10, 6, dtype=dt).apply(
                {"params": {"weight": table}}, jnp.asarray(ids)) for dt in (JBF, jnp.float32)])):
        got = lin(T_(x).to(BF)) if dt_name == "linear" else emb(torch.from_numpy(ids))
        assert got.dtype == BF
        held(dt_name, got, *refs)


def test_text_encoder_bf16_matches_jax(rng):
    """The TextEncoder (6 relative-attention layers at 48k_v2; 2 here) with
    its FFN, through kernel 2's bf16 plain version; float32 phone features
    cast at emb_phone, lengths < T on one row."""
    B, T = 2, 25
    phone = rng.standard_normal((B, T, 24)).astype(np.float32)
    pitch = rng.integers(1, 256, (B, T))
    lengths = np.array([25, 13])
    args = (jnp.asarray(phone), jnp.asarray(pitch), jnp.asarray(lengths))
    mk = lambda dt: jsyn.TextEncoder(24, 8, 16, 32, 2, 2, 3, 0.0, dtype=dt)  # noqa: E731
    p = with_biases(rng, finit(lambda *a: mk(jnp.float32).init(jax.random.PRNGKey(0), *a),
                               *args, seed=3))
    refs = [mk(dt).apply(p, *args) for dt in (JBF, jnp.float32)]
    t = load(tsyn.TextEncoder(24, 8, 16, 32, 2, 2, 3), p)
    with torch.no_grad():
        m, logs, _ = t(T_(phone), torch.from_numpy(pitch), torch.from_numpy(lengths))
    held("text encoder m", m, refs[0][0], refs[1][0], transpose=True)
    held("text encoder logs", logs, refs[0][1], refs[1][1], transpose=True)


def test_flows_reverse_bf16_matches_jax(rng):
    """The four couplings with their WN stacks, reverse direction."""
    B, T, C = 2, 20, 8
    x = bf(rng.standard_normal((B, T, C)))
    g = bf(rng.standard_normal((B, 1, 6)))
    jm, tm = masks(B, T, [20, 14])
    mk = lambda dt: jflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6,  # noqa: E731
                                                 dtype=dt)
    p = finit(lambda *a: mk(jnp.float32).init(jax.random.PRNGKey(0), *a, reverse=True),
              jnp.asarray(x), jnp.asarray(jm), jnp.asarray(g), seed=4)
    p = with_biases(rng, p)
    refs = [mk(dt).apply(p, jnp.asarray(x).astype(dt), jnp.asarray(jm).astype(dt),
                         jnp.asarray(g).astype(dt), reverse=True) for dt in (JBF, jnp.float32)]
    t = load(tflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6), p)
    with torch.no_grad():
        got = t.reverse(T_(x).transpose(1, 2).to(BF), T_(tm).to(BF),
                        g=T_(g).transpose(1, 2).to(BF))
    held("flows reverse", got, *refs, transpose=True)


# three dilations per chain: the Pallas stage kernel takes exactly three
# units (rvc_tpu/ops/pallas_resblock.py:639)
SYNTH = dict(spec_channels=129, segment_size=16, inter_channels=16, hidden_channels=16,
             filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
             resblock="1", resblock_kernel_sizes=(3, 5),
             resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)), upsample_rates=(10, 4, 2, 2),
             upsample_initial_channel=32, upsample_kernel_sizes=(16, 8, 4, 4), spk_embed_dim=4,
             gin_channels=8, sr=16000, feature_dim=32, use_f0=True)
FUSED = dict(fuse_resblocks=True, fuse_group=True, fuse_attention=True)


def test_synthesizer_infer_bf16_matches_jax(rng, monkeypatch):
    """Synthesizer.infer in bf16 with the JAX run's draws: eps drawn in bf16
    (m_p's dtype), the sine draws in float32; the float32 run replays the
    same draws. The JAX module runs its Pallas kernels (stage kernel,
    banded attention) in interpret mode, as the port runs theirs; this is
    the decoder's test too (its ResBlock1 stages through kernel 1's bf16
    plain version)."""
    B, T = 2, 24
    feat = rng.standard_normal((B, T, 32)).astype(np.float32)
    lens = np.array([T, T - 5])
    pitch = rng.integers(1, 255, (B, T))
    pitchf = (rng.uniform(0, 300, (B, T)) * (rng.uniform(size=(B, T)) > 0.3)).astype(np.float32)
    sid = np.array([0, 2])
    args = tuple(map(jnp.asarray, (feat, lens, pitch, pitchf, sid)))
    mk = lambda dt: jsyn.Synthesizer(**SYNTH, **FUSED, dtype=dt)  # noqa: E731
    j32 = mk(jnp.float32)
    p = with_biases(rng, finit(lambda *a: j32.init({"params": jax.random.PRNGKey(0),
                                                    "noise": jax.random.PRNGKey(1)}, *a,
                                                   method=j32.infer), *args, seed=3))

    def infer(dt):
        j = mk(dt)
        fn = lambda p, *a: j.apply(p, *a, method=j.infer,  # noqa: E731
                                   rngs={"noise": jax.random.PRNGKey(5)})
        # bf16 op by op: under jit XLA keeps excess precision inside fused
        # element-wise chains, which is not the dtype's rounding
        return (fn if dt == JBF else jax.jit(fn))(p, *args)

    with recorded_draws(monkeypatch) as draws:
        ref_b = infer(JBF)
    jax.effects_barrier()
    eps, rand_ini, noise = draws
    assert eps.dtype == JBF
    with monkeypatch.context() as m:
        left = replayed_draws(m, draws)
        ref_f = infer(jnp.float32)
    assert not left
    t = load(tsyn.Synthesizer(**SYNTH), p)
    inputs = tuple(map(torch.from_numpy, (feat, lens, pitch, pitchf, sid)))
    draws_t = dict(eps=T_(np.asarray(eps, np.float32)).transpose(1, 2).to(BF),
                   rand_ini=T_(rand_ini), noise=T_(noise))
    with torch.no_grad():
        o, _, (z, _, m_p, _) = t.infer(*inputs, **draws_t)
        t.dec.fuse_group = False
        o_per_chain = t.infer(*inputs, **draws_t)[0]
    (ob, _, (zb, _, mb, _)), (of, _, (zf, _, mf, _)) = ref_b, ref_f
    assert o.dtype == BF
    held("synthesizer m_p", m_p, mb, mf, transpose=True)
    held("synthesizer z", z, zb, zf, transpose=True)
    held("synthesizer output", o, ob, of, transpose=True)
    # the decoder's fuse_group=False route (kernel 8's plain version per
    # ResBlock, the chains added in order and divided in bf16): the same bits
    assert torch.equal(o, o_per_chain)


HUBERT = dict(hidden_size=32, num_hidden_layers=12, num_attention_heads=2,
              intermediate_size=64, conv_dim=(16,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
              conv_kernel=(10, 3, 3, 3, 3, 2, 2), classifier_proj_size=8,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def test_hubert_bf16_matches_jax(rng):
    """HuBERT v2 (11 layers) in bf16, the second row zero-padded past its
    length; its valid frames are compared."""
    x = rng.standard_normal((2, 6400)).astype(np.float32)
    lengths = np.array([6400, 4000])
    x[1, 4000:] = 0.0
    mk = lambda dt: jhub.HubertEncoder(jhub.HubertConfig(**HUBERT), dtype=dt)  # noqa: E731
    p = with_biases(rng, finit(lambda a: mk(jnp.float32).init(jax.random.PRNGKey(2), a,
                                                             output_layer=12),
                               jnp.zeros((1, 3200)), seed=6))
    refs = [np.asarray(jax.jit(lambda p, a, n, j=mk(dt): j.apply(
        p, a, version="v2", lengths=n, method=j.extract_features))(
        p, jnp.asarray(x), jnp.asarray(lengths)), np.float32) for dt in (JBF, jnp.float32)]
    t = load(thub.HubertEncoder(thub.HubertConfig(**HUBERT), "v2"), p, weights.hubert_state_dict)
    with torch.no_grad():
        got = t.extract_features(T_(x), torch.from_numpy(lengths))
    assert got.dtype == BF
    n_valid = int(np.asarray(jhub.conv_output_lengths(jhub.HubertConfig(**HUBERT),
                                                      jnp.asarray(lengths)))[1])
    held("hubert row 0", got[0], refs[0][0], refs[1][0])
    held("hubert row 1 (valid frames)", got[1, :n_valid], refs[0][1, :n_valid],
         refs[1][1, :n_valid])


def test_rmvpe_bf16_matches_jax(rng):
    """RMVPE's mel (float32, then cast), E2E at reduced widths (1 block per
    level, 4 base channels) with the BiGRU in bf16, and the decode in
    float32. The salience is held to the bar; the share of f0 frames that
    differ from the JAX module's bf16 f0 (an argmax or voicing flip: random
    weights give a nearly flat salience) is printed, beside the share that
    differ between the JAX module's bf16 and float32 f0."""
    x = (0.3 * rng.standard_normal((2, 64 * 160))).astype(np.float32)
    mel = np.array(jrmvpe.mel_frontend(jnp.asarray(x)))[:, :64]
    mk = lambda dt: jrmvpe.E2E(n_blocks=1, en_out_channels=4, dtype=dt)  # noqa: E731
    p = finit(lambda a: mk(jnp.float32).init(jax.random.PRNGKey(3), a), jnp.asarray(mel),
              seed=7)
    p = jax.tree_util.tree_map_with_path(  # non-trivial batch-norm statistics
        lambda path, a: rng.uniform(0.5, 2, a.shape).astype(np.float32)
        if path[-1].key == "running_var" else a, p)
    mel_b = jnp.asarray(mel).astype(JBF)
    refs = [jax.jit(mk(dt).apply)(p, jnp.asarray(mel).astype(dt)) for dt in (JBF, jnp.float32)]
    assert refs[0].dtype == JBF
    t = tlayers.load_numpy_state_dict(trmvpe.E2E(n_blocks=1, en_out_channels=4),
                                      weights.rmvpe_state_dict({"params": {"model": p["params"]}}))
    t = tlayers.set_dtype_(t.eval(), BF)
    with torch.no_grad():
        sal = t(T_(np.asarray(mel_b, np.float32)).to(BF))
    assert sal.dtype == BF
    held("rmvpe salience", sal, *refs)
    f0 = trmvpe.decode_cents(sal.float(), 0.03).numpy()
    f0_b, f0_f = (np.asarray(jrmvpe.decode_cents(r.astype(jnp.float32), 0.03)) for r in refs)
    differ = lambda a, b: float(np.mean(np.abs(a - b) > 1e-2 * np.maximum(b, 1.0)))  # noqa: E731
    print(f"rmvpe f0 frames that differ: port bf16 vs JAX bf16 {differ(f0, f0_b):.2%}, "
          f"JAX bf16 vs JAX float32 {differ(f0_b, f0_f):.2%}")
