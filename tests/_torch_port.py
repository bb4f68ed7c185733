"""Shared helpers of the ``test_torch_*`` files: the JAX package and its
PyTorch port fed the same numpy inputs, weights and random draws."""
import contextlib
import functools

import jax
import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def no_compile_cache_writes():
    """Keep the JAX calls of a port test out of the persistent compile cache
    (the cache lives in the repository's tree), restoring the setting after
    the module."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def finit(init_fn, *args, seed=0, **kwargs):
    """Random params as the JAX package's fast_init draws them, as numpy."""
    from rvc_tpu.utils.fastinit import fast_init

    return np_tree(fast_init(init_fn, *args, seed=seed, **kwargs))


@contextlib.contextmanager
def recorded_draws(monkeypatch):
    """Wrap jax.random.normal / uniform so that each call records its output,
    in call order, also under jit (an ordered debug callback). Draws made
    while flax only checks shapes are abstract and not recorded."""
    draws = []

    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            jax.debug.callback(lambda x: draws.append(np.array(x)), out, ordered=True)
            return out
        return wrapped

    monkeypatch.setattr(jax.random, "normal", wrap(jax.random.normal))
    monkeypatch.setattr(jax.random, "uniform", wrap(jax.random.uniform))
    yield draws
    jax.effects_barrier()


def replayed_draws(monkeypatch, draws) -> list:
    """jax.random.normal / uniform return the recorded ``draws`` in call
    order, cast to the dtype asked for (a float32 run on a bf16 run's
    draws); a call of another shape (flax checking a parameter's
    initializer) draws as before. Returns the draws not yet replayed."""
    pending = list(draws)

    def wrap(fn):
        def replay(key, shape=(), dtype=jax.numpy.float32, *args, **kwargs):
            if pending and pending[0].shape == tuple(shape):
                return jax.numpy.asarray(pending.pop(0)).astype(dtype)
            return fn(key, shape, dtype, *args, **kwargs)
        return replay

    monkeypatch.setattr(jax.random, "normal", wrap(jax.random.normal))
    monkeypatch.setattr(jax.random, "uniform", wrap(jax.random.uniform))
    return pending
