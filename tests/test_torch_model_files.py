"""The port's loaders of a user's model files (``compat.torch_import``)
against the JAX package's, on the CPU: an RVC ``.pth`` written by the JAX
package's exporter (fp16, weight_g/weight_v, ``conv.1`` FFN names) and a
copy under the reference's ``conv_1`` names, v1 and v2, f0 and no-f0, a
five-stage decoder; a tiny HF HuBERT as ``.safetensors`` under both
weight-norm namings; an RMVPE ``.pt``, bare and under ``"model"``."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (NARROW_RMVPE, finit, narrow_jax_rmvpe, no_compile_cache_writes,  # noqa: F401
                         recorded_draws)
from rvc_tpu.compat import torch_export as jexport
from rvc_tpu.compat import torch_import as jimport
from rvc_tpu.models import hubert as jhub
from rvc_tpu.models import rmvpe as jrmvpe
from rvc_tpu.models import synthesizer as jsyn
from rvc_tpu_torch.compat import torch_import as timport
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.models import hubert as thub
from rvc_tpu_torch.models import layers as tlayers
from rvc_tpu_torch.models import rmvpe as trmvpe
from rvc_tpu_torch.models import synthesizer as tsyn

T_ = torch.from_numpy
# the reference's positional config, narrowed: [spec, segment, inter, hidden,
# filter, heads, layers, kernel, dropout, resblock, rb kernels, rb dilations,
# upsample rates, upsample initial, upsample kernels, speakers, gin, sr];
# the speaker count is a real checkpoint's 109, emb_g has 4 rows
FOUR_STAGES = [129, 16, 16, 16, 32, 2, 2, 3, 0.0, "1", [3, 5], [[1, 3], [1, 2]],
               [10, 4, 2, 2], 32, [16, 8, 4, 4], 109, 8, 16000]
FIVE_STAGES = FOUR_STAGES[:12] + [[10, 4, 2, 2, 2], 64, [16, 8, 4, 4, 4]] + FOUR_STAGES[15:]
CASES = {  # id: (config, sr entry, version, f0, FFN names)
    "v2-f0-conv.1": (FOUR_STAGES, 16000, "v2", 1, "conv.1"),
    "v2-f0-conv_1": (FOUR_STAGES, 16000, "v2", 1, "conv_1"),
    "v1-f0-five-stages": (FIVE_STAGES, "32k", "v1", 1, "conv_1"),
    "v1-nof0": (FOUR_STAGES, "40k", "v1", 0, "conv_1"),
    "v2-nof0-conv.1": (FOUR_STAGES, 16000, "v2", 0, "conv.1"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_rvc_checkpoint_loads_as_jax_loads_it(case, tmp_path, monkeypatch):
    """The same .pth through both loaders: the same metadata and kwargs, and
    Synthesizer.infer on the same inputs and the JAX run's draws within
    2e-4 (float32 in another order; the weights are the file's fp16
    values on both sides, folded here, applied as (g, v) there)."""
    config, sr, version, f0, ffn = CASES[case]
    config = config[:-1] + [sr]
    jkw = jimport.synthesizer_kwargs_from_config(config, version, f0)
    jkw["spk_embed_dim"] = 4
    j = jsyn.Synthesizer(**jkw)
    rng = np.random.default_rng(len(case))
    B, T, D = 2, 12, jkw["feature_dim"]
    feat = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.array([T, T - 4])
    pitch = rng.integers(1, 255, (B, T))
    pitchf = (rng.uniform(0, 300, (B, T)) * (rng.uniform(size=(B, T)) > 0.3)).astype(np.float32)
    sid = np.array([0, 3])
    pa = (jnp.asarray(pitch), jnp.asarray(pitchf)) if f0 else (None, None)
    p = finit(lambda f, n, s: j.init({"params": jax.random.PRNGKey(0),
                                      "noise": jax.random.PRNGKey(1)}, f, n, *pa, s,
                                     method=j.infer),
              jnp.asarray(feat), jnp.asarray(lens), jnp.asarray(sid), seed=4)
    path = os.path.join(tmp_path, "model.pth")
    jexport.save_rvc_checkpoint(path, p, config, sr, f0=f0, version=version)
    cpt = torch.load(path, weights_only=True)
    assert any(".ffn_layers.0.conv.1." in k for k in cpt["weight"])
    assert any(k.endswith(".weight_g") for k in cpt["weight"])
    if ffn == "conv_1":  # the reference's names
        cpt["weight"] = {k.replace(".conv.1.", ".conv_1.").replace(".conv.2.", ".conv_2."): v
                         for k, v in cpt["weight"].items()}
        torch.save(cpt, path)

    jparams, jmeta = jimport.load_rvc_checkpoint(path)
    state, meta = timport.load_rvc_checkpoint(path)
    assert meta == jmeta and meta["config"][-3] == 4
    kw = timport.synthesizer_kwargs_from_config(meta["config"], meta["version"], meta["f0"])
    assert kw == jimport.synthesizer_kwargs_from_config(jmeta["config"], jmeta["version"],
                                                        bool(jmeta["f0"]))
    assert kw["sr"] == {16000: 16000, "32k": 32000, "40k": 40000}[sr]
    assert not any(k.endswith(("weight_g", "weight_v")) for k in state)

    jj = jsyn.Synthesizer(**kw)
    fn = jax.jit(lambda p, f, n, s, *pa: jj.apply(p, f, n, *(pa or (None, None)), s,
                                                   method=jj.infer,
                                                   rngs={"noise": jax.random.PRNGKey(5)}))
    pargs = (jnp.asarray(pitch), jnp.asarray(pitchf)) if f0 else ()
    with recorded_draws(monkeypatch) as draws:
        o, _, _ = fn(jparams, jnp.asarray(feat), jnp.asarray(lens), jnp.asarray(sid), *pargs)
    jax.effects_barrier()
    t = tlayers.load_numpy_state_dict(tsyn.Synthesizer(**kw), state).eval()
    d = dict(eps=T_(draws[0]).transpose(1, 2))
    if f0:
        d.update(rand_ini=T_(draws[1]), noise=T_(draws[2]))
    with torch.no_grad():
        got, _, _ = t.infer(T_(feat), T_(lens), T_(pitch) if f0 else None,
                            T_(pitchf) if f0 else None, T_(sid), **d)
    ref = np.asarray(o)
    assert got.shape == (B, 1, T * int(np.prod(kw["upsample_rates"])))
    np.testing.assert_allclose(got.numpy(), ref.transpose(0, 2, 1), atol=2e-4, rtol=0)


HF = dict(hidden_size=32, num_hidden_layers=12, num_attention_heads=2, intermediate_size=64,
          conv_dim=(16,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
          conv_kernel=(10, 3, 3, 3, 3, 2, 2), classifier_proj_size=8,
          num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def hf_hubert_file(path: str, naming: str) -> dict:
    """A tiny HF HubertModel (+ final_proj) saved with safetensors.numpy,
    its config in the metadata, the positional conv's weight norm under
    ``naming`` ("weight_g" or "parametrizations"). Returns its arrays."""
    from safetensors.numpy import save_file
    from transformers import HubertConfig, HubertModel

    cfg = HubertConfig(do_stable_layer_norm=False, feat_extract_norm="group", **HF)
    torch.manual_seed(0)
    m = HubertModel(cfg).eval()
    m.final_proj = torch.nn.Linear(32, 8)
    sd = {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}
    pc = "encoder.pos_conv_embed.conv."
    names = {"weight_g": (pc + "weight_g", pc + "weight_v"),
             "parametrizations": (pc + "parametrizations.weight.original0",
                                  pc + "parametrizations.weight.original1")}
    g = sd.pop(names["weight_g"][0], None)
    if g is None:
        g = sd.pop(names["parametrizations"][0])
        v = sd.pop(names["parametrizations"][1])
    else:
        v = sd.pop(names["weight_g"][1])
    assert g.shape == (1, 1, HF["num_conv_pos_embeddings"])  # the norm is over dim 2
    sd[names[naming][0]], sd[names[naming][1]] = g, v
    save_file(sd, path, metadata={"config": cfg.to_json_string()})
    return sd


@pytest.mark.parametrize("naming,version", [("weight_g", "v1"), ("parametrizations", "v2")])
def test_hubert_safetensors_loads_as_jax_loads_it(tmp_path, naming, version):
    """The same .safetensors through both loaders: the same config, and
    extract_features (v2: 11 layers; v1: 8 layers and final_proj) on two
    rows, one zero-padded past its length, within 1e-4 (as the port's
    HuBERT test holds it; the positional conv's folded weight differs from
    JAX's refolded one by the 1e-12 in the norm)."""
    path = os.path.join(tmp_path, "hubert.safetensors")
    hf_hubert_file(path, naming)
    jparams, jcfg = jimport.load_hubert_safetensors(path)
    state, cfg = timport.load_hubert_safetensors(path)
    assert cfg == thub.HubertConfig(**{k: getattr(jcfg, k) for k in HF
                                       if k != "num_hidden_layers"},
                                    num_hidden_layers=12)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6400)).astype(np.float32)
    lengths = np.array([6400, 4000])
    x[1, 4000:] = 0.0
    j = jhub.HubertEncoder(jcfg)
    ref = jax.jit(lambda p, a, n: j.apply(p, a, version=version, lengths=n,
                                          method=j.extract_features))(
        jparams, jnp.asarray(x), jnp.asarray(lengths))
    t = thub.HubertEncoder(cfg, version)
    used = t.state_dict()
    assert set(used) <= set(state)
    tlayers.load_numpy_state_dict(t, {k: v for k, v in state.items() if k in used}).eval()
    with torch.no_grad():
        got = t.extract_features(T_(x), T_(lengths)).numpy()
    n_valid = int(np.asarray(jhub.conv_output_lengths(j.cfg, jnp.asarray(lengths)))[1])
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1, :n_valid], ref[1, :n_valid], atol=1e-4, rtol=0)


def test_safetensors_reader_is_bit_exact(tmp_path):
    """The port's reader against safetensors.safe_open on F32, F16 and BF16
    tensors (and an int64 one), bit for bit, with the metadata."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"a.f32": torch.randn(3, 5, generator=g),
               "b.f16": torch.randn(7, generator=g).half(),
               "c.bf16": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "d.i64": torch.arange(6).reshape(2, 3), "e.scalar": torch.tensor(2.5)}
    path = os.path.join(tmp_path, "t.safetensors")
    save_file(tensors, path, metadata={"config": json.dumps({"x": 1})})
    got, meta = timport.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        assert meta == f.metadata()
        assert set(got) == set(f.keys())
        for k in f.keys():
            ref = f.get_tensor(k)
            assert got[k].dtype == ref.dtype and got[k].shape == ref.shape, k
            assert torch.equal(got[k].view(torch.uint8) if got[k].dim() else got[k],
                               ref.view(torch.uint8) if ref.dim() else ref), k


@pytest.fixture(scope="module")
def rmvpe_params():
    """Random RMVPE params (the E2E net narrowed, ``narrow_jax_rmvpe``), and
    the JAX f0 function (one compile)."""
    with narrow_jax_rmvpe():
        rm = jrmvpe.RMVPE()
        p = finit(lambda x: rm.init(jax.random.PRNGKey(3), x), jnp.zeros((1, 16000)), seed=3)
        yield p, jax.jit(rm.apply)


@pytest.mark.parametrize("wrapped", [False, True], ids=["bare", "model-key"])
def test_rmvpe_pt_loads_as_jax_loads_it(tmp_path, rmvpe_params, wrapped):
    """An RMVPE .pt (E2E names, with num_batches_tracked, bare or as
    {"model": state_dict}; the net narrowed, as the loaders take any
    widths) through both loaders: f0 on 0.5 s of a voiced
    tone with noise. Bar: 1e-2 of f0 on every frame (an argmax or voicing
    flip would move a frame by much more)."""
    params, f0_fn = rmvpe_params
    sd = {k: torch.tensor(v) for k, v in weights.rmvpe_state_dict(params).items()}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    path = os.path.join(tmp_path, "rmvpe.pt")
    torch.save({"model": sd} if wrapped else sd, path)
    t_audio = np.arange(8000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 180 * t_audio)
             + 0.02 * np.random.default_rng(2).standard_normal(8000)).astype(np.float32)[None]
    ref = np.asarray(f0_fn(jimport.load_rmvpe(path), jnp.asarray(audio)))
    t = trmvpe.RMVPE(**NARROW_RMVPE)
    tlayers.load_numpy_state_dict(t.model, timport.load_rmvpe(path)).eval()
    with torch.no_grad():
        got = t(T_(audio)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-2)
