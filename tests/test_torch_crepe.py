"""The port's CREPE against the JAX package's on the CPU: the network (tiny
on 0.5 s of speech, full on 4 frames) on the same torchcrepe-named random
weights, each decoder fed the JAX network's salience, end-to-end f0 of the
crepe methods (the mangio ones resized to the 100 Hz grid), the network in
bf16, and the torchcrepe file loader."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu.compat.torch_import import crepe_params_from_state_dict
from rvc_tpu.models import crepe as jcrepe
from rvc_tpu.pitch.extractor import PitchExtractor
from rvc_tpu_torch.compat import torch_import, weights
from rvc_tpu_torch.models import crepe as tcrepe
from rvc_tpu_torch.models.layers import load_numpy_state_dict, set_dtype_
from rvc_tpu_torch.models.rmvpe import BatchNorm
from rvc_tpu_torch.pitch.extractor import PitchExtractor as TPitchExtractor
from test_torch_convert import speech

pytestmark = pytest.mark.usefixtures("one_thread")

TINY_TOL = 1e-5  # salience (0..1), tiny net: float32 sums in another order
FULL_TOL = 1e-4  # salience, full net: K = 65536 sums at conv2
F0_REL = 1e-5    # end-to-end f0 where both voice: bins_to_hz's pow in another library


def _pair(capacity, seed):
    """(JAX params, port net) on the same random torchcrepe-named weights,
    through the JAX loader's tree and the port's bridge."""
    sd = tcrepe.random_state_dict(capacity, seed)
    jp = crepe_params_from_state_dict(sd)
    net = load_numpy_state_dict(tcrepe.CrepeNet(capacity), weights.crepe_state_dict(
        jax.tree.map(np.asarray, jp)))
    return jp, net.eval()


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny", 11)


@pytest.fixture(scope="module")
def audio():
    return speech(0.5, offset_s=12.0)[None]


@pytest.fixture(scope="module")
def tiny_salience(tiny, audio):
    """(JAX salience, port salience) of the tiny net at the 160 hop."""
    jp, net = tiny
    frames = jcrepe.preprocess_frames(jnp.asarray(audio), 160)
    B, n, _ = frames.shape
    ref = np.asarray(jcrepe.CrepeNet(capacity="tiny").apply(
        jp, frames.reshape(B * n, -1))).reshape(B, n, -1)
    return ref, tcrepe.salience(net, torch.from_numpy(audio)).numpy()


def test_tiny_salience_matches_jax(tiny_salience):
    ref, got = tiny_salience
    err = np.abs(got - ref).max()
    print(f"tiny salience: max |diff| {err:.3g}, spread {ref.std():.3g}, {ref.shape}")
    assert got.shape == ref.shape == (1, 51, 360)
    assert ref.std() > 0.02  # the weights make the salience move with the input
    assert err <= TINY_TOL


def test_full_salience_matches_jax(audio):
    jp, net = _pair("full", 12)
    frames = np.array(jcrepe.preprocess_frames(jnp.asarray(audio), 160))[0, 20:24]
    ref = np.asarray(jcrepe.CrepeNet(capacity="full").apply(jp, jnp.asarray(frames)))
    with torch.no_grad():
        got = net(torch.from_numpy(frames)).numpy()
    err = np.abs(got - ref).max()
    print(f"full salience on 4 frames: max |diff| {err:.3g}, spread {ref.std():.3g}")
    assert ref.std() > 0.02
    assert err <= FULL_TOL


def test_preprocess_frames_matches_jax(audio):
    """Per-frame mean and standard deviation (ddof 0) normalization."""
    for hop in (160, 64):
        ref = np.asarray(jcrepe.preprocess_frames(jnp.asarray(audio), hop))
        got = tcrepe.preprocess_frames(torch.from_numpy(audio), hop).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


def test_decoders_match_jax_bit_for_bit(tiny_salience):
    """Each decoder fed the JAX net's salience (masked to 50-1100 Hz as
    predict masks it) gives JAX's bins, bit for bit; also on a bump moving
    over the bins, and on a salience with tied costs, where both take the
    lowest bin."""
    ref, _ = tiny_salience
    mask = np.asarray(jcrepe.bins_to_hz(jnp.arange(360)))
    probs = np.where((mask >= 50) & (mask <= 1100), ref, 0.0).astype(np.float32)
    tied = np.zeros((2, 6, 360), np.float32)
    tied[:, :, 100:110] = 0.5  # ten bins alike on every frame
    tied[1, 3, 200] = 0.9
    r = np.random.default_rng(4)  # a bump on a random walk of bins, in noise
    walk = np.clip(150 + np.cumsum(r.integers(-3, 4, (2, 40)), -1), 0, 359)
    bump = np.exp(-0.5 * ((np.arange(360) - walk[..., None]) / 3.0) ** 2)
    moving = (0.7 * bump + 0.3 * r.random((2, 40, 360))).astype(np.float32)
    paths = []
    for p in (moving, probs, tied):
        jv = np.asarray(jcrepe.viterbi_decode(jnp.asarray(p)))
        tv = tcrepe.viterbi_decode(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(tv, jv)
        jw = np.asarray(jcrepe.weighted_argmax_decode(jnp.asarray(p)))
        tw = tcrepe.weighted_argmax_decode(torch.from_numpy(p)).numpy()
        np.testing.assert_array_equal(tw, jw)
        paths.append(jv)
    print(f"Viterbi bins on a moving bump: {len(np.unique(paths[0]))} distinct; on the "
          f"net's salience: {np.unique(paths[1])}; tied: {paths[2]}")
    assert len(np.unique(paths[0])) > 10 and (paths[2] == 100).any()


@pytest.mark.parametrize("method", ["crepe-tiny", "mangio-crepe-tiny"])
def test_crepe_f0_matches_jax(tiny, audio, method):
    """End to end through PitchExtractor.compute: the Viterbi route with its
    median, mean and 0.1 gate at the 160 hop; the mangio route at hop 64,
    resized to the 100 Hz grid. The same voicing on every frame, f0 within
    F0_REL where voiced."""
    jp, net = tiny
    ref = np.asarray(PitchExtractor(crepe_tiny_params=jp).compute(
        jnp.asarray(audio), method, crepe_hop_length=64))
    got = TPitchExtractor(crepe_tiny=net).compute(
        torch.from_numpy(audio), method, crepe_hop_length=64).numpy()
    print(f"{method}: {int((ref > 0).sum())} of {ref.shape[1]} frames voiced")
    assert got.shape == ref.shape
    assert got.shape[1] == (len(audio[0]) // 160 + (method == "crepe-tiny"))
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert (ref > 0).sum() > 10
    np.testing.assert_allclose(got, ref, rtol=F0_REL, atol=0)


def test_tiny_bf16_matches_jax_bf16(tiny, audio, tiny_salience):
    """The net in bf16 against JAX's CrepeNet(dtype=bfloat16), on JAX's
    frames: within twice JAX's own bf16-to-float32 distance (max |diff|),
    as tests/test_torch_bf16_convert.py sets its bar."""
    jp, net = tiny
    frames = jcrepe.preprocess_frames(jnp.asarray(audio), 160)[0]
    ref32 = np.asarray(jcrepe.CrepeNet(capacity="tiny").apply(jp, frames))
    ref16 = np.asarray(jcrepe.CrepeNet(capacity="tiny", dtype=jnp.bfloat16).apply(
        jp, frames).astype(jnp.float32))
    net16 = set_dtype_(tcrepe.CrepeNet("tiny"), torch.bfloat16)
    net16.load_state_dict(net.state_dict())
    with torch.no_grad():
        got = net16(torch.from_numpy(np.asarray(frames))).float().numpy()
    own = np.abs(ref16 - ref32).max()
    err = np.abs(got - ref16).max()
    print(f"bf16 salience: port vs JAX bf16 {err:.3g}; JAX bf16 vs float32 {own:.3g}")
    assert 0 < own and err <= 2 * own


def test_load_crepe_file(tmp_path, tiny):
    """A torchcrepe state_dict file loads as it is, num_batches_tracked left
    out, read with weights_only."""
    _, net = tiny
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    for i in range(1, 7):
        sd[f"conv{i}_BN.num_batches_tracked"] = torch.tensor(0)
    torch.save(sd, tmp_path / "tiny.pth")
    got = torch_import.load_crepe(str(tmp_path / "tiny.pth"))
    assert set(got) == set(net.state_dict())
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(got[k], v.numpy())


def test_torchcrepe_batchnorm_eps_size(tiny, audio):
    """torchcrepe builds its BatchNorm2d with Keras's eps (about 1e-3); the
    JAX package and the port fold it with 1e-5. The size of that difference
    on these random weights is printed (ROADMAP section 3 keeps it); it is
    above the salience bar, so the two are not interchangeable."""
    _, net = tiny
    eps3 = tcrepe.CrepeNet("tiny")
    eps3.load_state_dict(net.state_dict())
    for m in eps3.modules():
        if isinstance(m, BatchNorm):
            m.eps = 0.0010000000474974513
    with torch.no_grad():
        a = tcrepe.salience(net, torch.from_numpy(audio))
        b = tcrepe.salience(eps3.eval(), torch.from_numpy(audio))
    d = (a - b).abs().max().item()
    print(f"salience, BatchNorm eps 1e-3 against 1e-5: max |diff| {d:.3g}")
    assert d > TINY_TOL
