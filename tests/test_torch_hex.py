"""The port's Hex against the JAX package's, move for move, and against the
independent golden model. Boards, seats, obs, valid, rewards and terminal
must be bit-equal, auto-reset included."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu_torch.envs import hex as thex
from golden_hex import GoldenHex

torch.set_num_threads(2)

_jstep = jax.jit(lambda w, a: w.step(a))
_jprobe = jax.jit(lambda w: (w.obs, w.valid))


@pytest.mark.parametrize("boardsize", [3, 5, 9])
def test_random_games_match_jax(boardsize):
    rng = np.random.default_rng(100 + boardsize)
    n_envs = 16
    jw = jhex.Hex.initial(n_envs=n_envs, boardsize=boardsize)
    tw = thex.Hex.initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    n_terminal = 0
    for ply in range(3 * boardsize * boardsize):
        j_obs, j_valid = map(np.asarray, _jprobe(jw))
        np.testing.assert_array_equal(tw.obs.numpy(), j_obs, err_msg=f"obs ply {ply}")
        np.testing.assert_array_equal(tw.valid.numpy(), j_valid, err_msg=f"valid ply {ply}")
        actions = np.array([rng.choice(np.flatnonzero(v)) for v in j_valid], np.int32)
        jw, jtr = _jstep(jw, jnp.asarray(actions))
        tw, ttr = tw.step(torch.from_numpy(actions))
        np.testing.assert_array_equal(tw.board.numpy(), np.asarray(jw.board), err_msg=f"board ply {ply}")
        np.testing.assert_array_equal(tw.seats.numpy(), np.asarray(jw.seats))
        np.testing.assert_array_equal(ttr.rewards.numpy(), np.asarray(jtr.rewards))
        np.testing.assert_array_equal(ttr.terminal.numpy(), np.asarray(jtr.terminal))
        assert tw.board.dtype == torch.uint8 and tw.seats.dtype == torch.int32
        n_terminal += int(ttr.terminal.sum())
    assert n_terminal > 0  # auto-reset was exercised


@pytest.mark.parametrize("boardsize", [3, 5, 9])
def test_golden_equivalence(boardsize):
    rng = np.random.default_rng(2026)
    n_envs = 8
    world = thex.Hex.initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    golden = [GoldenHex(boardsize) for _ in range(n_envs)]
    for ply in range(2 * boardsize * boardsize):
        obs, valid = world.obs.numpy(), world.valid.numpy()
        actions = []
        for e in range(n_envs):
            gv = golden[e].valid()
            np.testing.assert_array_equal(valid[e], gv, err_msg=f"valid env {e} ply {ply}")
            np.testing.assert_array_equal(obs[e], golden[e].obs(), err_msg=f"obs env {e} ply {ply}")
            actions.append(rng.choice(np.flatnonzero(gv)))
        world, transition = world.step(torch.tensor(actions))
        for e in range(n_envs):
            g_terminal, g_rewards = golden[e].step(actions[e])
            assert bool(transition.terminal[e]) == g_terminal
            np.testing.assert_array_equal(transition.rewards[e].numpy(), g_rewards)


def test_flood_and_reset_cases():
    # the JAX package's regression boards (tests/test_hex.py), on the port
    board = torch.tensor([[[0, 6, 6], [1, 1, 1], [0, 2, 0]]], dtype=torch.uint8)
    world = thex.Hex(board=board, seats=torch.zeros((1,), dtype=torch.int32))
    world, _ = world.step(torch.tensor([6]), reset=False)
    assert world.board[0].tolist() == [[0, 6, 6], [4, 4, 4], [4, 2, 0]]

    world = thex.Hex.initial(n_envs=1, boardsize=3, device="cpu")
    for a in [5, 5, 6, 1]:
        world, _ = world.step(torch.tensor([a]))
    assert world.board[0].tolist() == [[0, 0, 0], [5, 0, 1], [4, 2, 0]]

    board = torch.zeros((1, 3, 3), dtype=torch.uint8)
    board[0, 0, 1], board[0, 2, 1] = thex.TOP, thex.BOT
    world = thex.Hex(board=board, seats=torch.zeros((1,), dtype=torch.int32))
    world, tr = world.step(torch.tensor([4]))
    assert bool(tr.terminal[0]) and tr.rewards[0].tolist() == [1.0, -1.0]
    assert int(world.board.sum()) == 0 and int(world.seats[0]) == 0


def test_initial_needs_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is valid")
    with pytest.raises(RuntimeError):
        thex.Hex.initial(n_envs=1, boardsize=3)
