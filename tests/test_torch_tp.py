"""The port's 2-D ``(dp, tp)`` mesh on the CPU: ``parallel.mesh``'s
``make_mesh_2d``, ``tp_param_spec`` and ``shard_params_tp``, and
``Trainer(mesh=)``, the counterparts of ``rvc_tpu/parallel/mesh.py:53-82``
and of the JAX dry run's stage 2.

- ``tp_param_spec`` places every generator and discriminator parameter of
  JAX's ``tiny_config()`` and of ``48k_v2`` as JAX's rule places the JAX
  parameter of the same torch-layout name (shapes only: the JAX trees by
  ``jax.eval_shape``, the port's modules on the meta device).
- ``run_dryrun(4, device="cpu")`` passes (four gloo ranks, each a spawned
  process on one thread); its stage 2, a 2 x 2 step at ``tiny_config()``,
  is held here to the port's one-process step on the same batch and draws
  within ``LOSS_TOL`` (1e-5) in losses, gradient norms and updated
  parameters. The one-process step is held to JAX's by
  tests/test_torch_train_step.py. A gradient summed over tp (``n_tp``
  times too large) moves both gradient norms by a factor of 2, far past
  the bar.
- After the update every rank's parameters are still its ``tp_param_spec``
  slices, and the four ranks' metrics and gathered parameters are equal.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_port import no_compile_cache_writes, one_thread  # noqa: F401
from rvc_tpu import config as jconfig
from rvc_tpu.parallel import dryrun as jdryrun
from rvc_tpu.parallel.mesh import tp_param_spec as jax_tp_param_spec
from rvc_tpu.train.step import Trainer as JaxTrainer
from rvc_tpu_torch.compat.weights import flax_path_to_torch_key
from rvc_tpu_torch.config import RVCConfig
from rvc_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from rvc_tpu_torch.models.layers import live_weight_norm_
from rvc_tpu_torch.models.synthesizer import Synthesizer
from rvc_tpu_torch.parallel import dryrun
from rvc_tpu_torch.parallel.mesh import tp_param_spec
from rvc_tpu_torch.pipelines.convert import synth_kwargs_from_config

pytestmark = pytest.mark.usefixtures("one_thread")

N_TP = 2
CONFIGS = {"tiny_config": jdryrun.tiny_config, "48k_v2": lambda: jconfig.preset("48k_v2")}


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _jax_shapes(cfg) -> dict:
    """{"g.<name>" / "d.<name>": shape} of the JAX Trainer's parameters, by
    their torch-layout names, from ``jax.eval_shape`` of its inits."""
    jt = JaxTrainer(cfg)
    T, d = 48, cfg.data
    sds = jax.ShapeDtypeStruct
    batch = (sds((1, T, jt.synth.feature_dim), jnp.float32), sds((1,), jnp.int32),
             sds((1, T), jnp.int32), sds((1, T), jnp.float32),
             sds((1, T, d.filter_length // 2 + 1), jnp.float32), sds((1,), jnp.int32),
             sds((1,), jnp.int32))
    key = jax.random.PRNGKey(0)
    g = jax.eval_shape(functools.partial(jt.synth.init, {"params": key, "noise": key}), *batch)
    seg = sds((1, cfg.train.segment_size, 1), jnp.float32)
    dd = jax.eval_shape(functools.partial(jt.disc.init, key), seg, seg)
    return {f"{p}.{flax_path_to_torch_key(path)}": tuple(leaf.shape)
            for p, tree in (("g", g), ("d", dd)) for path, leaf in _flat(tree["params"]).items()}


def _port_shapes(cfg) -> dict:
    """{"g.<name>" / "d.<name>": shape} of ``Trainer(cfg)``'s parameters,
    built on the meta device."""
    pcfg = RVCConfig.from_json(cfg.to_json())
    with torch.device("meta"):
        synth = live_weight_norm_(Synthesizer(**synth_kwargs_from_config(pcfg), posterior=True))
        disc = MultiPeriodDiscriminator(pcfg.model.version, scale=pcfg.model.disc_scale)
    return {f"{p}.{k}": tuple(v.shape) for p, m in (("g", synth), ("d", disc))
            for k, v in m.named_parameters()}


@pytest.fixture(scope="module")
def runs(one_thread):
    """``run_dryrun(4, "cpu")``'s return value (stage 2's results); JAX's
    and the port's parameter shapes are taken while its ranks run."""
    with ThreadPoolExecutor(1) as pool:
        dry = pool.submit(dryrun.run_dryrun, 4, "cpu")
        shapes = {name: (_jax_shapes(make()), _port_shapes(make()))
                  for name, make in CONFIGS.items()}
        return {"tp": dry.result(), "shapes": shapes}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_param_spec_matches_jax(runs, name):
    """Every parameter's placement is the one JAX's rule gives the JAX
    parameter of the same name: tp-sharded on dim 0 exactly where JAX's
    PartitionSpec starts with "tp", replicated over dp always."""
    jax_shapes, port_shapes = runs["shapes"][name]
    assert set(port_shapes) == set(jax_shapes)
    n_sharded = 0
    for key, shape in port_shapes.items():
        assert shape == jax_shapes[key], key
        dp, tp = tp_param_spec(shape, N_TP)
        jspec = jax_tp_param_spec(jax.ShapeDtypeStruct(jax_shapes[key], jnp.float32), N_TP)
        assert dp.is_replicate(), key
        assert tp.is_shard() == (len(jspec) > 0 and jspec[0] == "tp"), key
        assert tp.is_replicate() == (len(jspec) == 0), key
        if tp.is_shard():
            assert tp.dim == 0
            n_sharded += 1
    assert 0 < n_sharded < len(port_shapes)


def test_dp_tp_step_matches_one_process(runs):
    """The dry run's 2 x 2 step against one process's step on the whole
    batch: losses, gradient norms and every updated parameter within
    LOSS_TOL; the ranks' metrics and parameters equal; every rank's local
    parameters still their tp slices after the update."""
    tp = runs["tp"]
    d = dryrun.tp_distances(tp["ranks"], tp["one"], N_TP)
    assert d["loss"] <= dryrun.LOSS_TOL, d
    assert d["norm"] <= dryrun.LOSS_TOL, d
    assert d["param"] <= dryrun.LOSS_TOL, d
    assert d["equal"] and d["sliced"], d
    assert all(r["metrics"] == tp["ranks"][0]["metrics"] for r in tp["ranks"])
    assert len(tp["ranks"]) == 4 and all(r["step"] == 1 for r in tp["ranks"])
    sharded = {k for k, (_, s) in tp["ranks"][0]["shards"].items() if s}
    assert d["tp_sharded_g"] == sum(k.startswith("g.") for k in sharded) > 0


def test_run_dryrun_four_cpu_ranks(runs):
    """``run_dryrun(4, "cpu")`` returns (each of its checks raises), having
    run stage 2: its results are the return value."""
    assert set(runs["tp"]) == {"ranks", "one"}


def test_mesh_and_trainer_default_to_the_card():
    """make_mesh_2d and Trainer(mesh=) take the card unless the CPU is
    asked for, and raise without one (before any process group is needed)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from rvc_tpu_torch.parallel.mesh import make_mesh_2d
    from rvc_tpu_torch.train.step import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_2d(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(RVCConfig.from_json(jdryrun.tiny_config().to_json()), mesh=object())
