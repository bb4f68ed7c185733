"""Training checkpoints, warm starts, the ``.pth`` export and the checkpoint
tools of the port, on the CPU at ``tiny_config()``: a resumed run against an
uninterrupted one (bit for bit), and the warm start, the export and
``process_ckpt`` against the JAX package's."""
import types

import jax
import numpy as np
import pytest
import torch

from _torch_port import no_compile_cache_writes, np_tree, one_thread  # noqa: F401
from rvc_tpu.compat import process_ckpt as jpc
from rvc_tpu.compat import torch_export as jexport
from rvc_tpu.compat.torch_import import load_rvc_checkpoint as jax_load_rvc
from rvc_tpu.parallel.dryrun import make_tiny_batch, tiny_config
from rvc_tpu.pipelines import train as jtrain
from rvc_tpu.train import checkpoints as jck
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch import config as tconfig
from rvc_tpu_torch.compat import process_ckpt as tpc
from rvc_tpu_torch.compat import weights
from rvc_tpu_torch.compat.torch_import import load_rvc_checkpoint
from rvc_tpu_torch.pipelines import convert as tconvert
from rvc_tpu_torch.pipelines import train as ttrain
from rvc_tpu_torch.train import checkpoints as tck
from rvc_tpu_torch.train.step import Trainer

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def tiny(monkeypatch):
    """(JAX tiny config, the port's, one numpy batch); the port's synthesizer
    takes features of width 16, as the tiny batch has."""
    kwargs_of = tconvert.synth_kwargs_from_config
    monkeypatch.setattr(tconvert, "synth_kwargs_from_config",
                        lambda c: {**kwargs_of(c), "feature_dim": 16})
    cfg = tiny_config()
    batch = {k: np.asarray(v) for k, v in make_tiny_batch(2).items()}
    return cfg, tconfig.RVCConfig.from_json(cfg.to_json()), batch


@pytest.fixture(scope="module")
def jax_init():
    """The JAX Trainer's initial weights at tiny_config (fast_init), as
    reference-named numpy state_dicts and as trees."""
    cfg = tiny_config()
    jt = JaxTrainer(cfg)
    object.__setattr__(jt.synth, "feature_dim", 16)
    st = jt.init_state(jax.random.PRNGKey(0), make_tiny_batch(2), steps_per_epoch=1,
                       fast_params=True)
    g, d = np_tree(st.params_g), np_tree(st.params_d)
    return {"g": g, "d": d, "g_sd": weights.synthesizer_state_dict(g, fold=False),
            "d_sd": weights.discriminator_state_dict(d)}


def _snapshot(trainer, state):
    out = {f"g.{k}": v.clone() for k, v in trainer.synth.state_dict().items()}
    out.update({f"d.{k}": v.clone() for k, v in trainer.disc.state_dict().items()})
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        out.update({f"{name}.m{i}": t.clone() for i, t in enumerate(opt.m)})
        out.update({f"{name}.v{i}": t.clone() for i, t in enumerate(opt.v)})
    for name in ("balancer_g", "balancer_d"):
        out.update({f"{name}.{i}": t.clone() for i, t in enumerate(getattr(state, name))})
    return out, (state.step, state.opt_g.count, state.opt_d.count)


def test_resumed_run_equals_an_uninterrupted_one(tiny, jax_init, tmp_path):
    """Two steps straight against one step, a save, a restore into a fresh
    Trainer (other initial weights), one step: parameters, moments, counts
    and balancer states equal bit for bit. The schedule crosses an epoch
    between the steps (one step an epoch); each step draws from its step
    number."""
    _, cfg, batch = tiny
    init = dict(state_g=jax_init["g_sd"], state_d=jax_init["d_sd"], steps_per_epoch=1)
    straight = Trainer(cfg, device="cpu")
    st = straight.init_state(**init)
    for _ in range(2):
        st, _ = straight.step(st, batch)
    want, want_counts = _snapshot(straight, st)

    first = Trainer(cfg, device="cpu")
    s1 = first.init_state(**init)
    s1, _ = first.step(s1, batch)
    path = tck.save_train_state(str(tmp_path), first, s1, s1.step)
    assert tck.latest_checkpoint(str(tmp_path)) == path and path.endswith("state_1")
    fresh = Trainer(cfg, device="cpu")
    s2 = fresh.init_state(seed=5, steps_per_epoch=1)
    live = [p.data_ptr() for p in fresh.synth.parameters()]
    s2 = tck.restore_train_state(path, fresh, s2)
    assert [p.data_ptr() for p in fresh.synth.parameters()] == live
    assert all(a is b for a, b in zip(s2.opt_g.params, fresh.synth.parameters()))
    assert s2.step == 1 and s2.opt_g.count == s2.opt_d.count == 1
    s2, _ = fresh.step(s2, batch)
    got, got_counts = _snapshot(fresh, s2)
    assert got_counts == want_counts == (2, 2, 2)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_latest_checkpoint_takes_the_highest_step(tmp_path):
    for name in ("state_9", "state_10", "state_2", "state_x", "states_11"):
        (tmp_path / name).write_bytes(b"")
    assert tck.latest_checkpoint(str(tmp_path)) == jck.latest_checkpoint(str(tmp_path))
    assert tck.latest_checkpoint(str(tmp_path)).endswith("state_10")
    assert tck.latest_checkpoint(str(tmp_path / "none")) is None


@pytest.mark.parametrize("which,key", [("g", "model"), ("d", "weight")])
def test_warm_start_matches_jax(tiny, jax_init, tmp_path, which, key):
    """A reference-named pretrained file (fp32 torch tensors under ``key``)
    with one key of another shape: ``load_pretrained_g`` + the overlay
    against the JAX ``load_pretrained_g`` + ``merge_pretrained``; the
    mismatched key keeps its initial value."""
    _, cfg, _ = tiny
    rng = np.random.default_rng(3)
    init_sd = jax_init[f"{which}_sd"]
    odd = "emb_g.weight" if which == "g" else "discriminators.0.conv_post.bias"
    pre = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in init_sd.items()}
    pre[odd] = rng.standard_normal((3,) + init_sd[odd].shape[1:]).astype(np.float32)
    path = str(tmp_path / f"{which.upper()}_0.pth")
    torch.save({key: {k: torch.from_numpy(v) for k, v in pre.items()}, "iteration": 1}, path)

    tree = jax_init[which]["params"]
    merged = jck.merge_pretrained(tree, jck.load_pretrained_g(path))
    ref = (weights.synthesizer_state_dict(merged, fold=False) if which == "g"
           else weights.discriminator_state_dict(merged))
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state(state_g=jax_init["g_sd"], state_d=jax_init["d_sd"])
    module = trainer.synth if which == "g" else trainer.disc
    tck.warm_start_(module, path)
    got = {k: v.numpy() for k, v in module.state_dict().items()}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(got[odd], init_sd[odd])
    other = next(k for k in ref if k != odd)
    np.testing.assert_array_equal(got[other], pre[other])


@pytest.fixture
def exported(tiny, jax_init, tmp_path):
    """The port's tiny trainer, exported by the training pipeline's export."""
    jcfg, cfg, _ = tiny
    trainer = Trainer(cfg, device="cpu")
    trainer.init_state(state_g=jax_init["g_sd"], state_d=jax_init["d_sd"])
    with torch.no_grad():  # weight_g away from 1, so that the pairs matter
        for name, p in trainer.synth.named_parameters():
            if name.endswith("weight_g"):
                p.mul_(1.25)
    run = ttrain.TrainRunConfig(model_dir=str(tmp_path), filelist="", export_name="tiny")
    return jcfg, cfg, trainer, ttrain._export(cfg, trainer, run)


def test_export_loads_through_both_loaders(exported, monkeypatch, tmp_path):
    """The port's ``.pth``: fp16, no enc_q, conv_1/conv_2, weight_g/weight_v.
    The JAX loader and the port's give its fp16 values exactly; its config
    list, sr, f0 and version are the JAX ``_export``'s for the same config."""
    jcfg, cfg, trainer, path = exported
    cpt = torch.load(path, map_location="cpu", weights_only=True)
    w = cpt["weight"]
    assert all(v.dtype == torch.float16 for v in w.values())
    assert not any(k.startswith("enc_q.") for k in w)
    assert any(".conv_1." in k for k in w) and not any(".conv.1." in k for k in w)
    assert any(k.endswith("weight_g") for k in w)
    want = {k: v.detach().half().float().numpy() for k, v in trainer.synth.state_dict().items()
            if not k.startswith("enc_q.")}
    assert set(w) == set(want)
    jparams, jmeta = jax_load_rvc(path)
    for got in (weights.synthesizer_state_dict(np_tree(jparams), fold=False),
                load_rvc_checkpoint(path, fold=False)[0]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    seen = {}
    monkeypatch.setattr(jexport, "save_rvc_checkpoint",
                        lambda p, params, config, **kw: seen.update(config=config, **kw))
    jtrain._export(jcfg, types.SimpleNamespace(params_g={}),
                   types.SimpleNamespace(model_dir=str(tmp_path), export_name="j"))
    assert cpt["config"] == seen["config"]
    assert (cpt["sr"], cpt["f0"], cpt["version"]) == (seen["sr"], seen["f0"], seen["version"])
    assert jmeta["config"] == load_rvc_checkpoint(path)[1]["config"]


def _same_file(a, b):
    x = torch.load(a, map_location="cpu", weights_only=False)
    y = torch.load(b, map_location="cpu", weights_only=False)
    assert x.keys() == y.keys()
    for k in x:
        if k == "weight":
            assert x[k].keys() == y[k].keys()
            for n in x[k]:
                assert x[k][n].dtype == y[k][n].dtype and torch.equal(x[k][n], y[k][n]), n
        else:
            assert x[k] == y[k], k


def test_process_ckpt_matches_jax(exported, tmp_path):
    """show_info, change_info, extract_small_model (from a training-format
    G file with enc_q and an optimizer) and merge (speaker tables of
    different rows) give what the JAX package's give."""
    _, _, trainer, path = exported
    assert tpc.show_info(path) == jpc.show_info(path)
    assert tpc.show_info(str(tmp_path / "missing.pth")).startswith("error")
    out = {k: str(tmp_path / f"{k}.pth") for k in ("t", "j")}
    assert tpc.change_info(path, "hello", out["t"]) == jpc.change_info(path, "hello", out["j"])
    _same_file(out["t"], out["j"])

    g_file = str(tmp_path / "G_5.pth")
    torch.save({"model": {k: v.detach().clone() for k, v in trainer.synth.state_dict().items()},
                "optimizer": {"state": {}, "param_groups": []}, "learning_rate": 1e-4,
                "iteration": 5}, g_file)
    args = ("40k", 1, "small", "v2", [1, 2, 3])
    assert tpc.extract_small_model(g_file, out["t"], *args) == \
        jpc.extract_small_model(g_file, out["j"], *args)
    _same_file(out["t"], out["j"])
    assert not any(k.startswith("enc_q") for k in torch.load(out["t"])["weight"])

    other = str(tmp_path / "other.pth")
    cpt = torch.load(path, weights_only=True)
    cpt["weight"] = {k: (v.float() * 0.5 + 0.01).half() for k, v in cpt["weight"].items()}
    cpt["weight"]["emb_g.weight"] = torch.ones(5, cpt["weight"]["emb_g.weight"].shape[1],
                                               dtype=torch.float16)
    torch.save(cpt, other)
    margs = (0.3, "40k", 1, "merged", None, "v2")
    m_t = tpc.merge(path, other, *margs[:4], out["t"], margs[5])
    m_j = jpc.merge(path, other, *margs[:4], out["j"], margs[5])
    assert m_t == m_j == "Success."
    _same_file(out["t"], out["j"])
    del cpt["weight"]["emb_g.weight"]
    torch.save(cpt, other)
    assert tpc.merge(path, other, *margs[:4], out["t"], margs[5]) == \
        jpc.merge(path, other, *margs[:4], out["j"], margs[5])
