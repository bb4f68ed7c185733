"""The port's training modules against their JAX counterparts on the CPU.

Weights are drawn once (the JAX package's fast_init, as numpy) and carried to
the port unfolded (``compat.weights.synthesizer_state_dict(fold=False)``,
``discriminator_state_dict``); both sides get the same numpy inputs and the
JAX side's random draws are recorded and handed over. Tolerance 1e-5
absolute at float32 unless a test says otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import finit, no_compile_cache_writes, np_tree, recorded_draws  # noqa: F401
from rvc_tpu.models import discriminator as jdisc
from rvc_tpu.models import flows as jflows
from rvc_tpu.models import layers as jlayers
from rvc_tpu.models import synthesizer as jsyn
from rvc_tpu.ops import mel as jmel
from rvc_tpu.train import balancer as jbal
from rvc_tpu.train import losses as jloss
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import discriminator as tdisc
from rvc_tpu_torch.models import flows as tflows
from rvc_tpu_torch.models import layers as tlayers
from rvc_tpu_torch.models import synthesizer as tsyn
from rvc_tpu_torch.ops import attention, mel as tmel, resblock
from rvc_tpu_torch.train import balancer as tbal
from rvc_tpu_torch.train import losses as tloss
from rvc_tpu_torch.train.step import AdamW, lr_schedule

T_ = torch.from_numpy


def close(got, ref, atol=1e-5, transpose=False):
    got = got.detach().numpy()
    ref = np.asarray(ref)
    if transpose:
        ref = np.swapaxes(ref, 1, 2)
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def masks(B, T, lengths):
    m = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return m[..., None], m[:, None, :]  # JAX (B, T, 1), port (B, 1, T)


def trainable(module, params):
    """The port module in its training form (live weight norm; with
    gradients wanted its WN stacks take the fused route) with the JAX
    tree's weights, unfolded."""
    tlayers.live_weight_norm_(module)
    return tlayers.load_numpy_state_dict(module, weights.synthesizer_state_dict(params,
                                                                                fold=False))


def with_biases(p, rng):
    """fast_init zeroes every bias; give them values so a test sees them."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if path[-1].key == "bias" else a, p)


SYN = dict(spec_channels=33, segment_size=8, inter_channels=8, hidden_channels=16,
           filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0,
           resblock="1", resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 2)),
           upsample_rates=(4, 2, 2), upsample_initial_channel=32,
           upsample_kernel_sizes=(8, 4, 4), spk_embed_dim=3, gin_channels=8, sr=1600,
           feature_dim=24, use_f0=True)


def test_posterior_encoder_matches_jax(rng):
    """16 WN layers through the port's fused route (the plain stack on the
    CPU) against the JAX module's layer loop; lengths < T on one row."""
    B, T, spec = 2, 30, 33
    y = rng.standard_normal((B, T, spec)).astype(np.float32)
    lens = np.array([30, 17])
    g = rng.standard_normal((B, 1, 8)).astype(np.float32)
    j = jsyn.PosteriorEncoder(spec, 8, 16, 5, 1, 16, gin_channels=8)
    key = jax.random.PRNGKey(3)
    p = with_biases(finit(lambda *a: j.init(jax.random.PRNGKey(0), *a, rng_key=key),
                          jnp.asarray(y), jnp.asarray(lens), jnp.asarray(g), seed=6), rng)
    z, m, logs, _ = j.apply(p, jnp.asarray(y), jnp.asarray(lens), jnp.asarray(g), rng_key=key)
    eps = np.asarray(jax.random.normal(key, (B, T, 8)))
    t = trainable(tsyn.PosteriorEncoder(spec, 8, 16, 5, 1, 16, gin_channels=8), p)
    z2, m2, logs2, _ = t(T_(y).transpose(1, 2), T_(lens), T_(g).transpose(1, 2),
                         eps=T_(eps).transpose(1, 2))
    close(m2, m, transpose=True)
    close(logs2, logs, transpose=True)
    close(z2, z, transpose=True)


def test_flow_forward_matches_jax(rng):
    B, T, C = 2, 20, 8
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    g = rng.standard_normal((B, 1, 6)).astype(np.float32)
    jm, tm = masks(B, T, [20, 14])
    x = x * jm
    j = jflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6)
    p = with_biases(finit(lambda *a: j.init(jax.random.PRNGKey(0), *a), jnp.asarray(x),
                          jnp.asarray(jm), jnp.asarray(g), seed=4), rng)
    ref = j.apply(p, jnp.asarray(x), jnp.asarray(jm), jnp.asarray(g))
    t = trainable(tflows.ResidualCouplingBlock(C, 12, 5, 1, 3, gin_channels=6), p)
    close(t(T_(x).transpose(1, 2), T_(tm), g=T_(g).transpose(1, 2)), ref, transpose=True)


def test_synthesizer_training_forward_matches_jax(rng, monkeypatch):
    """Synthesizer.forward with the JAX run's draws: the posterior sample's
    normal, the segment starts' uniform, the sine source's phase and noise."""
    B, T = 2, 20
    feat = rng.standard_normal((B, T, 24)).astype(np.float32)
    lens = np.array([T, 15])
    pitch = rng.integers(1, 255, (B, T))
    pitchf = (rng.uniform(0, 300, (B, T)) * (rng.uniform(size=(B, T)) > 0.3)).astype(np.float32)
    spec = np.abs(rng.standard_normal((B, T, 33))).astype(np.float32)
    sid = np.array([0, 2])
    args = tuple(map(jnp.asarray, (feat, lens, pitch, pitchf, spec, lens, sid)))
    j = jsyn.Synthesizer(**SYN)
    p = with_biases(finit(lambda *a: j.init({"params": jax.random.PRNGKey(0),
                                             "noise": jax.random.PRNGKey(1)}, *a),
                          *args, seed=3), rng)
    fn = jax.jit(lambda p, *a: j.apply(p, *a, rngs={"noise": jax.random.PRNGKey(5)}))
    with recorded_draws(monkeypatch) as draws:
        o, ids, _, _, flows = fn(p, *args)
    jax.effects_barrier()
    eps_q, u, rand_ini, noise = draws
    t = trainable(tsyn.Synthesizer(**SYN, posterior=True), p)
    o2, ids2, _, _, flows2 = t(*map(T_, (feat, lens, pitch, pitchf, spec, lens, sid)),
                               eps_q=T_(eps_q).transpose(1, 2), u_slice=T_(u),
                               rand_ini=T_(rand_ini), noise=T_(noise))
    np.testing.assert_array_equal(ids2.numpy(), np.asarray(ids))
    for got, ref in zip(flows2, flows):  # z, z_p, m_p, logs_p, m_q, logs_q
        close(got, ref, transpose=True)
    close(o2, o, transpose=True)


def test_slices_match_jax(rng):
    x = rng.standard_normal((3, 10, 4)).astype(np.float32)
    lens = np.array([10, 6, 3])
    ref, ids = jlayers.rand_slice_segments(jax.random.PRNGKey(0), jnp.asarray(x),
                                           jnp.asarray(lens), 4)
    u_ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (3,)))
    got, ids2 = tlayers.rand_slice_segments(T_(x).transpose(1, 2), T_(lens), 4, u=T_(u_ref))
    np.testing.assert_array_equal(ids2.numpy(), np.asarray(ids))
    close(got, ref, 0, transpose=True)
    starts = np.array([0, 5, 9])  # 9 is past T - 4: clamped, as dynamic_slice clamps
    w = rng.standard_normal((3, 10)).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.slice_segments(T_(w), T_(starts), 4).numpy(),
        np.asarray(jlayers.slice_segments(jnp.asarray(w), jnp.asarray(starts), 4)))


@pytest.mark.parametrize("scale,T", [(1.0 / 16, 700), (1.0, 160)])
def test_multi_period_discriminator_matches_jax(rng, scale, T):
    """MPD v2 (the scale discriminator and periods 2..37): logits and every
    feature map, for real and generated; at scale 1 the grouped convs of the
    reference topology, T not a multiple of most periods (reflect pad)."""
    B = 2
    y = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    y_hat = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    j = jdisc.MultiPeriodDiscriminator(version="v2", scale=scale)
    p = with_biases(finit(lambda *a: j.init(jax.random.PRNGKey(0), *a), jnp.asarray(y),
                          jnp.asarray(y_hat), seed=7), rng)
    ref = j.apply(p, jnp.asarray(y), jnp.asarray(y_hat))
    t = tlayers.load_numpy_state_dict(tdisc.MultiPeriodDiscriminator("v2", scale=scale),
                                      weights.discriminator_state_dict(p))
    got = t(T_(y).transpose(1, 2), T_(y_hat).transpose(1, 2))
    for side in (0, 1):  # logits
        for a, b in zip(got[side], ref[side]):
            close(a, b, 1e-4)
    for side in (2, 3):  # feature maps: JAX channels-last
        for fa, fb in zip(got[side], ref[side]):
            for a, b in zip(fa, fb):
                b = np.asarray(b)
                b = np.moveaxis(b, -1, 1)
                np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-4, rtol=0)


@pytest.mark.parametrize("sr,n_fft,hop,n_mels", [(48000, 2048, 480, 128), (6400, 64, 64, 16)])
def test_mel_frontends_match_jax(rng, sr, n_fft, hop, n_mels):
    """Slaney-scale log-mel of a waveform and of a linear spectrogram, and
    the waveform's gradient (the mel loss trains through it). 48k_v2's
    frontend and the tiny test configuration's."""
    wav = (0.3 * rng.standard_normal((2, 12 * hop))).astype(np.float32)
    spec = np.abs(rng.standard_normal((2, 12, n_fft // 2 + 1))).astype(np.float32)
    cot = rng.standard_normal((2, 12, n_mels)).astype(np.float32)
    args = (n_fft, n_mels, sr, hop, n_fft, 0.0, None)

    def loss(w):
        m = jmel.mel_spectrogram(w, *args)
        return jnp.sum(m * cot), m

    (_, ref), gref = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(wav))
    w = T_(wav).requires_grad_()
    got = tmel.mel_spectrogram(w, *args)
    (got * T_(cot)).sum().backward()
    close(got, ref, 1e-4)
    scale = float(np.max(np.abs(np.asarray(gref))))
    np.testing.assert_allclose(w.grad.numpy() / scale, np.asarray(gref) / scale, atol=1e-4)
    ref = jmel.spec_to_mel(jnp.asarray(spec), n_fft, n_mels, sr, 0.0, None)
    close(tmel.spec_to_mel(T_(spec), n_fft, n_mels, sr, 0.0, None), ref, 1e-5)


def test_losses_match_jax(rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    disc_r, disc_g = [f(2, 7), f(2, 3)], [f(2, 7), f(2, 3)]
    fmap_r = [[f(2, 4, 5), f(2, 3)], [f(2, 6)]]
    fmap_g = [[f(2, 4, 5), f(2, 3)], [f(2, 6)]]
    J, P = (lambda xs: [jnp.asarray(a) for a in xs]), (lambda xs: [T_(a) for a in xs])
    np.testing.assert_allclose(
        float(tloss.feature_loss([P(a) for a in fmap_r], [P(a) for a in fmap_g])),
        float(jloss.feature_loss([J(a) for a in fmap_r], [J(a) for a in fmap_g])), rtol=1e-6)
    np.testing.assert_allclose(float(tloss.discriminator_loss(P(disc_r), P(disc_g))[0]),
                               float(jloss.discriminator_loss(J(disc_r), J(disc_g))[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tloss.generator_loss(P(disc_g))[0]),
                               float(jloss.generator_loss(J(disc_g))[0]), rtol=1e-6)
    B, T, C = 2, 9, 4
    z_p, m_p, logs_p, logs_q = f(B, T, C), f(B, T, C), 0.1 * f(B, T, C), 0.1 * f(B, T, C)
    jm, tm = masks(B, T, [9, 5])
    ref = jloss.kl_loss(*map(jnp.asarray, (z_p, logs_q, m_p, logs_p, jm)))
    got = tloss.kl_loss(*(T_(a).transpose(1, 2) for a in (z_p, logs_q, m_p, logs_p)), T_(tm))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    a, b = f(2, 12, 16), f(2, 12, 16)
    np.testing.assert_allclose(float(tloss.mel_l1(T_(a), T_(b))),
                               float(jloss.mel_l1(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    w = T_(f(2, 640))
    assert [float(v) for v in tloss.combined_aux_loss(w, w, c_tefs=0.0, c_hd=0.0,
                                                      c_tsi=0.0)] == [
        float(v) for v in jloss.combined_aux_loss(jnp.asarray(w.numpy()),
                                                  jnp.asarray(w.numpy()),
                                                  c_tefs=0.0, c_hd=0.0, c_tsi=0.0)]


def test_balancer_matches_jax_over_3_steps(rng):
    """The generator's 7-loss balancer (three aux losses at 0, skipped):
    the total, its gradient with respect to the losses (the step trains
    through the weights) and the state, over 3 steps."""
    w0 = np.array([1.0, 1.0, 45.0, 1.0, 0.0, 0.0, 0.0], np.float32)
    js, ts = jbal.init_state(7), tbal.init_state(7)
    for _ in range(3):
        losses = np.concatenate([rng.uniform(0.2, 5.0, 4), np.zeros(3)]).astype(np.float32)

        def total(lv, st=js):
            tot, new, wts = jbal.balance(st, lv, jnp.asarray(w0))
            return tot, (new, wts)

        (ref, (js, jw)), jgrad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(losses))
        lt = T_(losses).requires_grad_()
        got, ts, tw = tbal.balance(ts, lt, T_(w0))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jw), rtol=1e-5)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_adamw_matches_optax(rng):
    """3 updates, the schedule crossing an epoch (2 steps per epoch):
    optax.adamw with the trainer's betas, eps and decay."""
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = lr_schedule(1e-2, 0.5, 2)
    tx = optax.adamw(learning_rate=sched, b1=0.8, b2=0.99, eps=1e-9, weight_decay=0.01)
    jp = [jnp.asarray(a) for a in params]
    js = tx.init(jp)
    tp = [torch.tensor(a) for a in params]
    opt = AdamW(tp, sched, (0.8, 0.99), 1e-9)
    for _ in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, js = tx.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([T_(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=1e-6)


def _flax_tree(state):
    """Reference-named state_dict -> the JAX package's nested tree."""
    tree = {}
    for key, arr in state.items():
        parts, path, i = key.split("."), [], 0
        while i < len(parts):
            if i + 1 < len(parts) - 1 and parts[i + 1].isdigit():
                path.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        node = tree
        for q in path[:-1]:
            node = node.setdefault(q, {})
        node[path[-1]] = arr
    return tree


def test_unfolded_weights_round_trip(rng):
    """JAX trees -> the port's trainable modules (every weight_v/weight_g
    and enc_q.*) -> state_dicts -> JAX trees, unchanged."""
    B, T = 2, 12
    args = tuple(map(jnp.asarray, (
        rng.standard_normal((B, T, 24)).astype(np.float32), np.array([T, 9]),
        rng.integers(1, 255, (B, T)), rng.uniform(50, 300, (B, T)).astype(np.float32),
        rng.standard_normal((B, T, 33)).astype(np.float32), np.array([T, 9]), np.array([0, 1]))))
    j = jsyn.Synthesizer(**SYN)
    pg = finit(lambda *a: j.init({"params": jax.random.PRNGKey(0),
                                  "noise": jax.random.PRNGKey(1)}, *a), *args, seed=1)
    seg = jnp.zeros((B, 64, 1))
    jd = jdisc.MultiPeriodDiscriminator(version="v2", scale=1.0 / 16)
    pd = finit(lambda *a: jd.init(jax.random.PRNGKey(0), *a), seg, seg, seed=2)
    tg = trainable(tsyn.Synthesizer(**SYN, posterior=True), pg)
    td = tlayers.load_numpy_state_dict(tdisc.MultiPeriodDiscriminator("v2", scale=1.0 / 16),
                                       weights.discriminator_state_dict(pd))
    for module, tree in ((tg, pg), (td, pd)):
        back = _flax_tree({k: v.numpy() for k, v in module.state_dict().items()})
        ref = np_tree(tree["params"])
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    assert any(k.startswith("enc_q.") for k in tg.state_dict())
    assert not any(k.endswith(".weight") and "convs" in k for k in td.state_dict())


def test_forward_only_kernels_refuse_grad():
    """Kernels 1 and 2 (and 4, alone) have no backward: asked for one they
    raise before any device dispatch, so the CPU sees it too."""
    x = torch.zeros(1, 20, 16, requires_grad=True)
    w, b = torch.zeros(16, 16, 3), torch.zeros(16)
    chain = [(w, b, 3, 1), (w, b, 3, 1)]
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock_group(x, [chain])
    with pytest.raises(RuntimeError, match="no backward"):
        resblock.fused_resblock1(x, chain)
    q = torch.zeros(1, 2, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.banded_rel_attention(q, q, q, torch.zeros(3, 32), torch.zeros(3, 32),
                                       torch.tensor([8]), window=1, scale=0.5)
    with torch.no_grad():  # inference: no gradient wanted, the wrappers run
        resblock.fused_resblock_group(x, [chain])
        attention.banded_rel_attention(q, q, q, torch.zeros(3, 32), torch.zeros(3, 32),
                                       torch.tensor([8]), window=1, scale=0.5)
