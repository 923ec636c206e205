"""The random draws the JAX package's solvers make from a PRNG key, as the
port's samplers return them: a port run can be fed the JAX run's own
samples and compared outcome for outcome (the two packages' generators
differ). Used by the tests/test_torch_*.py files."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from orb_slam2_with_comment_tpu_torch.solvers import (initializer, pnp,
                                                      sim3solver)


def quads(key, valid, T, S=4):
    """pnp.solve_ransac's minimal sets: Gumbel top-k over valid slots."""
    g = jax.random.gumbel(key, (T, valid.shape[0]))
    g = jnp.where(jnp.asarray(valid)[None, :], g, -jnp.inf)
    return np.asarray(jax.lax.top_k(g, S)[1])


def _categorical(key, valid, n):
    valid = jnp.asarray(valid)
    nv = jnp.sum(valid.astype(jnp.int32))
    probs = valid.astype(jnp.float32) / jnp.clip(nv, 1, None)
    return np.asarray(jax.random.categorical(
        key, jnp.log(jnp.clip(probs, 1e-12, None))[None, :].repeat(n, 0)))


def triplets(key, valid, T):
    """sim3solver.solve_ransac's 3-point sets."""
    return _categorical(key, valid, T * 3).reshape(T, 3)


def octets(key, valid, iterations=200):
    """initializer.initialize's 8-point sets."""
    return _categorical(key, valid, iterations * 8).reshape(iterations, 8)


def _np(t):
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def jax_samples(quad_key=None, octet_key=None, triplet_keys=None):
    """Within the block the port's samplers return the JAX draws:
    ``quad_key()`` / ``octet_key()`` give the key of each call (called at
    draw time), ``triplet_keys`` is an iterator of keys, one per Sim3
    RANSAC."""
    saved = pnp.sample_quads, initializer.sample_octets, \
        sim3solver.sample_triplets
    if quad_key is not None:
        pnp.sample_quads = lambda gen, valid, max_iters, sample_size=4: (
            torch.tensor(quads(quad_key(), _np(valid), max_iters,
                                  sample_size)).long().to(valid.device))
    if octet_key is not None:
        initializer.sample_octets = lambda gen, valid, iterations=200: (
            torch.tensor(octets(octet_key(), _np(valid), iterations))
            .long().to(valid.device))
    if triplet_keys is not None:
        sim3solver.sample_triplets = lambda gen, valid, max_iters: (
            torch.tensor(triplets(next(triplet_keys), _np(valid),
                                     max_iters)).long().to(valid.device))
    try:
        yield
    finally:
        (pnp.sample_quads, initializer.sample_octets,
         sim3solver.sample_triplets) = saved


def key_chain(seed=7):
    """The sub-keys of the JAX LoopCloser: key, sub = split(key) per
    Sim3 RANSAC, from PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sub = jax.random.split(key)
        yield sub
