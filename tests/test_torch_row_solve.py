"""The row kernels' design, checked on the CPU (csrc/row_solve.cuh).

* The early exit: the kernels leave the solve loop once every row of a warp
  has converged, where the twin runs all of its steps with converged rows
  frozen. That is bit-exact: for each row, `kernels.solve_steps` gives the
  step in which its convergence test first holds, and `search.node_probs`
  run for that many steps gives the full solve's alpha bit for bit, for the
  K=1 Newton solve (16 steps, one-sided test) and the K>1 accelerated solve
  (6 steps, two-sided test), on `_random_tree`s and on a tree of the JAX
  package's own search. The full alpha agrees with the JAX `node_probs`'s
  to rtol 1e-5 (the exp and the sums are other code than XLA's).
* The lane layout, whose Python mirror (`kernels.row_layout`,
  `kernels.row_grid`) the wrappers pass to the kernels: for every board the
  repo runs, groups of G lanes (a power of two, at most 32) hold a row's A
  actions once each, and the grid holds every row (or env) once, also for
  the leading live rows `search._node_actions_any` hands over.

The kernels themselves run on the card in tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import jax
import pytest
import torch

from boardlaw_tpu.mcts import search as S
from boardlaw_tpu_torch.mcts import kernels, search as TS
from test_torch_kernels import _port_inputs, _random_tree
from test_torch_search import _models, _port_tree, _worlds

torch.set_num_threads(2)

BOARD_ACTIONS = [9, 25, 36, 49, 81, 121]  # boards 3, 5, 6, 7, 9, 11


def _jax_search_tree():
    """The JAX package's tree after three K=4 scan passes on 5x5."""
    seed, B = 5, 8
    jeval, _ = _models(seed=seed)
    jworld = _worlds(5, B, 6, seed)
    cfg = S.MCTSConfig(n_nodes=13, leaves_per_pass=4, use_pallas=False, pallas_walk=False)

    def three_passes(w, key):
        k0, k1, k2, k3 = jax.random.split(key, 4)
        tree = S.initialize(S.build(w, cfg), jeval(w, None), k0, cfg, w.valid)
        for k in (k1, k2, k3):
            tree = S.simulate_multi(tree, jeval, k, cfg)
        return tree

    return jax.jit(three_passes)(jworld, jax.random.PRNGKey(seed))


def _check_early_exit(tree, n_iters, accel):
    pt = _port_tree(tree)
    args = [pt.logits, pt.n_edge, pt.w_edge, pt.c_puct, TS._q_bounds(pt)]
    steps = kernels.solve_steps(*args, n_iters=n_iters, accel=accel)
    _, full = TS.node_probs(*args, n_iters=n_iters, accel=accel, return_alpha=True)
    assert steps.dtype == torch.int32 and steps.shape == full.shape
    assert int(steps.min()) >= 1 and int(steps.max()) <= n_iters
    assert float(steps.float().mean()) < n_iters  # rows do converge early
    for k in steps.unique().tolist():
        _, alpha_k = TS.node_probs(*args, n_iters=k, accel=accel, return_alpha=True)
        rows = steps == k
        assert torch.equal(alpha_k[rows].view(torch.int32), full[rows].view(torch.int32)), k
    _, jalpha = S.node_probs(tree, S._q_bounds(tree), n_iters=n_iters, accel=accel,
                             return_alpha=True)
    np.testing.assert_allclose(full.numpy(), np.asarray(jalpha), rtol=1e-5, atol=0)
    return steps


@pytest.mark.parametrize("seed,c_puct,n_iters,accel", [
    (0, 1.0, 16, False), (2, 0.0625, 16, False), (9, 1.0, 6, True), (2, 0.0625, 6, True)])
def test_early_exit_is_bit_exact_on_random_trees(seed, c_puct, n_iters, accel):
    rng = np.random.default_rng(seed)
    _check_early_exit(_random_tree(rng, 16, 12, 7, c_puct=c_puct), n_iters, accel)


@pytest.fixture(scope="module")
def jax_tree():
    return _jax_search_tree()


@pytest.mark.parametrize("n_iters,accel", [(16, False), (6, True)])
def test_early_exit_is_bit_exact_on_a_search_tree(jax_tree, n_iters, accel):
    steps = _check_early_exit(jax_tree, n_iters, accel)
    # the search's rows converge in a few steps, well inside the budget
    assert float(steps.float().mean()) < 0.75 * n_iters


def test_solve_steps_counts_the_steps_the_twin_runs():
    # steps == n_iters exactly where the test never holds within the budget
    rng = np.random.default_rng(4)
    inp = _port_inputs(_random_tree(rng, 8, 12, 25, c_puct=0.0625))
    args = [inp[k] for k in ("logits", "n_edge", "w_edge", "c_puct", "q_bounds")]
    long = kernels.solve_steps(*args, n_iters=64, accel=False)
    for n in (1, 2, 4, 16):
        short = kernels.solve_steps(*args, n_iters=n, accel=False)
        assert torch.equal(short, long.clamp_max(n))


@pytest.mark.parametrize("A", BOARD_ACTIONS)
def test_row_layout_covers_every_row_once(A):
    G, J = kernels.row_layout(A)
    assert G in (8, 16) and G & (G - 1) == 0
    assert G * J >= A and J == -(-A // G) and J <= kernels.ROW_MAX_J
    # lane gl of a group holds actions gl + j*G: each action exactly once
    held = sorted(j * G + gl for j in range(J) for gl in range(G) if j * G + gl < A)
    assert held == list(range(A))

    per_warp = 32 // G
    B, T = 5, 13
    for R in (T, 7, 1):  # R < T: the leading live rows of the K=1 search
        for n in (B * R, B):  # node rows, or envs (descend)
            G2, blocks = kernels.row_grid(n, A)
            assert G2 == G
            ids = [(blk * kernels.WARPS_PER_BLOCK + w) * per_warp + g for blk in range(blocks)
                   for w in range(kernels.WARPS_PER_BLOCK) for g in range(per_warp)]
            live = [i for i in ids if i < n]
            assert sorted(live) == list(range(n))
            assert (blocks - 1) * kernels.WARPS_PER_BLOCK * per_warp < n  # no idle block
        # each row (b, t) reads its own A actions at env stride T*A
        starts = {(i // R) * T * A + (i % R) * A for i in range(B * R)}
        assert len(starts) == B * R and max(starts) + A <= B * T * A


@pytest.mark.parametrize("A", [0, 129])
def test_row_layout_refuses_rows_it_cannot_hold(A):
    with pytest.raises(ValueError):
        kernels.row_layout(A)
