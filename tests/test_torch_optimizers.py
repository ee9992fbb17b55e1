"""Outer optimizers: metapde_tpu.train.optimizers (optax) against the port's
functional ones (metapde_tpu_torch/train/optimizers.py).

Random param and gradient trees from numpy seeds; 20 steps each, with the
params moved by the updates on both sides. Tolerance: rtol 1e-6, atol 1e-7
on every params leaf after every step and on the final state leaves (f32;
optax and torch evaluate b**count and the square roots with their own
rounding). The updates themselves are held through the params: on a
lookahead sync the update is a difference of two O(1) numbers, which
carries the rounding of the params (1 ulp of 1.0 is 1.2e-7). Ranger's lookahead
syncs at steps 6, 12 and 18, so 20 steps cross three syncs.
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metapde_tpu.train import checkpoints as j_ckpt
from metapde_tpu.train import optimizers as j_opt
from metapde_tpu_torch.interop import params_from_numpy
from metapde_tpu_torch.train import checkpoints, optimizers
from metapde_tpu_torch.utils.trees import tree_leaves

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7
STEPS = 20
CKPT = (Path(__file__).resolve().parents[1] / "results_poisson_maml" / "p30k_f32_s1"
        / "checkpoint_step_30001.pickle")


def _tree(rng, scale=1.0):
    return {"layers": [{"w": scale * rng.normal(size=(2, 8)).astype(np.float32),
                        "b": scale * rng.normal(size=8).astype(np.float32)},
                       {"w": scale * rng.normal(size=(8, 1)).astype(np.float32),
                        "b": scale * rng.normal(size=1).astype(np.float32)}],
            "log_in_scale": scale * rng.normal(size=2).astype(np.float32)}


def _close(t_tree, j_tree):
    a, b = tree_leaves(t_tree), jax.tree_util.tree_leaves(j_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL, atol=ATOL)


def _run_both(j_tx, t_tx, seed, params, steps=STEPS, j_state=None, t_state=None):
    rng = np.random.default_rng(seed)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), params_from_numpy(params)
    j_state = j_tx.init(jp) if j_state is None else j_state
    t_state = t_tx.init(tp) if t_state is None else t_state
    for _ in range(steps):
        scale = rng.uniform(0.01, 3.0)
        g = jax.tree_util.tree_map(
            lambda p: scale * rng.normal(size=np.shape(p)).astype(np.float32), params)
        ju, j_state = j_tx.update(jax.tree_util.tree_map(jnp.asarray, g), j_state, jp)
        tu, t_state = t_tx.update(params_from_numpy(g), t_state, tp)
        jp = optax.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
        _close(tp, jp)
    return (jp, j_state), (tp, t_state)


@pytest.mark.parametrize("name,lr", [("adam", 1e-2), ("rmsprop", 1e-2), ("ranger", 1e-2),
                                     ("sgd", 1e-1), ("adam", 0.5)])
def test_optimizer_matches_optax_over_20_steps(name, lr):
    """("adam", 0.5) is the learned-LR optimizer of the driver."""
    params = _tree(np.random.default_rng(0))
    (_, j_state), (_, t_state) = _run_both(
        j_opt.get_optimizer(name, lr), optimizers.get_optimizer(name, lr), 1, params)
    if name in ("adam", "rmsprop"):
        _close([t_state["mu"], t_state["nu"]], [j_state[0].mu, j_state[0].nu])
        assert int(t_state["count"]) == int(j_state[0].count) == STEPS
    if name == "ranger":
        assert int(t_state["count"]) == int(j_state.count) == STEPS
        _close(t_state["slow"], j_state.slow)


def test_ranger_rectification_switches_on_inside_20_steps():
    """RAdam's rectified step starts at step 6 for b2 = 0.99 (rho >= 5):
    both sides take the first moment before it and the rectified step
    after, so the test above covers both branches."""
    b2 = 0.99
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    ro = [ro_inf - 2 * t * b2 ** t / (1 - b2 ** t) for t in range(1, STEPS + 1)]
    assert ro[4] < 5.0 <= ro[5]


def test_get_optimizer_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("lamb", 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        j_opt.get_optimizer("lamb", 1e-3)


def test_from_jax_state_on_the_p30k_adam_states():
    """The committed JAX checkpoint's Adam states (outer and learned-LR),
    read by the port's loader and rebuilt: the next updates equal optax's
    from the states the JAX loader reads."""
    j_state = j_ckpt.load_checkpoint(str(CKPT))
    t_state = checkpoints.load_checkpoint(str(CKPT))
    for key, tree_key, lr in (("opt_state", "params", 1e-5), ("lr_opt_state", "inner_lrs", 0.5)):
        j_tx = j_opt.get_optimizer("adam", lr)
        t_tx = optimizers.get_optimizer("adam", lr)
        jst = jax.tree_util.tree_map(jnp.asarray, j_state[key])
        tst = optimizers.from_jax_state("adam", t_state[key])
        assert int(tst["count"]) == 30001
        _run_both(j_tx, t_tx, 7, j_state[tree_key], steps=2, j_state=jst, t_state=tst)


def test_from_jax_state_for_ranger_reads_the_lookahead_state(tmp_path):
    """A JAX ranger state, pickled as the JAX package's checkpoints pickle it
    (its LookaheadState is a class of metapde_tpu), unpickles in the port
    without importing the JAX package and continues as optax does across a
    lookahead sync."""
    params = _tree(np.random.default_rng(3))
    j_tx = j_opt.get_optimizer("ranger", 1e-2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = j_tx.init(jp)
    rng = np.random.default_rng(4)
    for _ in range(4):
        u, j_state = j_tx.update(jax.tree_util.tree_map(jnp.asarray, _tree(rng)), j_state, jp)
        jp = optax.apply_updates(jp, u)
    host = jax.tree_util.tree_map(np.asarray, {"opt_state": j_state, "params": jp})
    fname = tmp_path / "ranger.pickle"
    fname.write_bytes(pickle.dumps(host, protocol=pickle.HIGHEST_PROTOCOL))
    state = checkpoints.load_checkpoint(str(fname))
    assert type(state["opt_state"]).__module__ == "metapde_tpu.train.optimizers"
    tst = optimizers.from_jax_state("ranger", state["opt_state"])
    assert int(tst["count"]) == 4
    _run_both(j_tx, optimizers.get_optimizer("ranger", 1e-2), 5, host["params"], steps=4,
              j_state=j_state, t_state=tst)
