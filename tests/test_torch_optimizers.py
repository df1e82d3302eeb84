"""The port's optimizers (training/optimizers.py) against optax through the
JAX package's ``build_optimizer`` (its update compiled, as in the JAX train
step): the same parameters and the same
gradient sequence (numpy, from a seed) over 8 steps, past RAdam's
rectification threshold (rho >= 5 from step 6), for every optimizer x
learning-rate schedule x clipping, and ``MultiSteps`` with k = 2.

Tolerance: each leaf's change from its start, rtol 2e-4 with atol 2e-5 x
the leaf's max |change| (the JAX tests' f32 tolerance, taken relative to
the change the steps make).  The parameters start near zero (std 1e-3), so
that the rounding of p + update, the same on both sides, stays far below
the change."""

import jax
import numpy as np
import optax
import pytest
import torch

from generative_turbulence_tpu.training import optimizers as jopt
from generative_turbulence_tpu_torch.training import optimizers as topt

SHAPES = [(3, 4), (5,), (2, 3, 2), (1,)]
STEPS = 8


def _params_and_grads(seed, steps, scale):
    rng = np.random.default_rng(seed)
    params = [(1e-3 * rng.normal(size=s)).astype(np.float32) for s in SHAPES]
    grads = [[(scale * rng.normal(size=s)).astype(np.float32) for s in SHAPES] for _ in range(steps)]
    return params, grads


def _assert_changes_close(got, want, start):
    for g, w, p0 in zip(got, want, start):
        change = np.asarray(w) - p0
        np.testing.assert_allclose(g - p0, change, rtol=2e-4, atol=2e-5 * np.abs(change).max())


def _run_both(kw, steps=STEPS, seed=0, scale=1.0):
    """Parameters after each step, optax's and the port's, and which steps
    the port reported as updates."""
    params, grads = _params_and_grads(seed, steps, scale)
    tx = jopt.build_optimizer(**kw)
    jparams = [np.array(p) for p in params]
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)  # compiled, as the train step runs it
    opt = topt.build_optimizer(**kw)
    tparams = [torch.tensor(p) for p in params]
    tstate = opt.init(tparams)
    history, updated = [], []
    for g in grads:
        updates, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        updated.append(opt.step_(tparams, [torch.tensor(x) for x in g], tstate))
        history.append(([p.numpy().copy() for p in tparams], [np.asarray(p) for p in jparams]))
    return params, history, updated


@pytest.mark.parametrize("clip", [None, 0.1], ids=["no-clip", "clip"])
@pytest.mark.parametrize("lr_decay", ["exp", "cosine", None], ids=["exp", "cosine", "constant"])
@pytest.mark.parametrize("optimizer", ["adam", "adamw", "radam"])
def test_optimizer_matches_optax(optimizer, lr_decay, clip):
    kw = dict(optimizer=optimizer, learning_rate=1e-2, min_learning_rate=1e-4, lr_decay=lr_decay,
              max_train_steps=10, gradient_clip_val=clip)
    start, history, updated = _run_both(kw)
    assert all(updated)
    for got, want in history:
        _assert_changes_close(got, want, start)
    # Each step moved every leaf (the comparison is not of zeros).
    assert all(np.abs(p - p0).min() > 0 for p, p0 in zip(history[-1][0], start))


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "radam"])
def test_multisteps_matches_optax(optimizer):
    """accumulate_steps = 2: updates on every second micro-step with the
    mean of the two gradients; the schedule counts updates only."""
    kw = dict(optimizer=optimizer, learning_rate=1e-2, min_learning_rate=1e-4, lr_decay="exp",
              max_train_steps=4, gradient_clip_val=0.1, accumulate_steps=2)
    start, history, updated = _run_both(kw, steps=2 * STEPS)
    assert updated == [False, True] * STEPS
    for step, (got, want) in enumerate(history):
        if step % 2 == 0:
            np.testing.assert_array_equal(got[0], (history[step - 1][0] if step else start)[0])
        _assert_changes_close(got, want, start)


def test_clip_is_exact_below_the_norm():
    """Below the clip norm the gradients pass unchanged (optax selects the
    unclipped tree); above it they are scaled to the norm."""
    opt = topt.build_optimizer(optimizer="adam", learning_rate=1.0, gradient_clip_val=10.0)
    g = [torch.tensor([3.0, 4.0])]
    assert torch.equal(opt._clip(g)[0], g[0])
    opt = topt.build_optimizer(optimizer="adam", learning_rate=1.0, gradient_clip_val=1.0)
    torch.testing.assert_close(opt._clip(g)[0], torch.tensor([0.6, 0.8]))


def test_exp_schedule_matches_jax():
    want = jopt.exp_decay_schedule(1e-4, 1e-6, 100)
    got = topt.exp_decay_schedule(1e-4, 1e-6, 100)
    for step in (0, 1, 50, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


@pytest.mark.parametrize("kw, match", [
    (dict(optimizer="sgd", learning_rate=1e-3), "optimizer"),
    (dict(optimizer="adam", learning_rate=1e-3, lr_decay="linear"), "lr decay"),
])
def test_unknown_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        topt.build_optimizer(**kw)
