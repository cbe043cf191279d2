"""The port's Hex against the JAX package's, move for move, and against the
independent golden model. Boards, seats, obs, valid, rewards and terminal
must be bit-equal, auto-reset included.

The rest of the module likewise: `board_actions`, `from_string` and
`render` on random ASCII boards of sizes 3 to 11; the one-player
`Solitaire` worlds `Lazy` and `Random` played move for move against the
JAX package's (`Random`'s opponent drawing from the JAX key's Gumbel noise,
fed through the port's `Draws`) and against the golden model (`Random`'s
opponent taking the argmax of the same Gumbel noise over the golden model's
valid cells)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu_torch.draws import Draws
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


def _step_both(jw, tw, pairs):
    """Step both packages with the same (n_envs, 2) int32 row/col pairs and
    compare boards, seats, terminal flags and rewards exactly."""
    jw, jtr = _jstep(jw, jnp.asarray(pairs))
    tw, ttr = tw.step(torch.from_numpy(pairs))
    np.testing.assert_array_equal(tw.board.numpy(), np.asarray(jw.board))
    np.testing.assert_array_equal(tw.seats.numpy(), np.asarray(jw.seats))
    np.testing.assert_array_equal(ttr.terminal.numpy(), np.asarray(jtr.terminal))
    np.testing.assert_array_equal(ttr.rewards.numpy(), np.asarray(jtr.rewards))
    return jw, tw, ttr


@pytest.mark.parametrize("pairs", [[[0, 1], [2, 3]], [[4, 4], [0, 0], [3, 1]]])
def test_row_col_actions_match_jax(pairs):
    pairs = np.array(pairs, np.int32)
    n_envs = len(pairs)
    jw = jhex.Hex.initial(n_envs=n_envs, boardsize=5)
    tw = thex.Hex.initial(n_envs=n_envs, boardsize=5, device="cpu")
    _, tw, _ = _step_both(jw, tw, pairs)
    flat = pairs[:, 0] * 5 + pairs[:, 1]
    # black's stone at row * S + col of each env, and no other stone
    assert (tw.board.flatten(1) != thex.EMPTY).sum(1).tolist() == [1] * n_envs
    assert [int(tw.board.flatten(1)[e, a]) != thex.EMPTY for e, a in enumerate(flat)] == [True] * n_envs


@pytest.mark.parametrize("boardsize", [5, 9])
def test_random_row_col_games_match_jax(boardsize):
    rng = np.random.default_rng(300 + boardsize)
    n_envs = 8
    jw = jhex.Hex.initial(n_envs=n_envs, boardsize=boardsize)
    tw = thex.Hex.initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    n_terminal = 0
    for _ in range(2 * boardsize * boardsize):
        valid = tw.valid.numpy()
        flat = np.array([rng.choice(np.flatnonzero(v)) for v in valid])
        pairs = np.stack(np.divmod(flat, boardsize), -1).astype(np.int32)
        jw, tw, ttr = _step_both(jw, tw, pairs)
        n_terminal += int(ttr.terminal.sum())
    assert n_terminal > 0  # the row/col games reached terminal states


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


def test_flood_stops_at_labelled_cells():
    # the flood crosses plain stones only: black's move at (0,2) takes TOP
    # and relabels its plain chain down to (2,2); the BOT cells below stop
    # it, and the plain stone at (3,3) behind them keeps its label. The
    # `hex_step` kernel keeps this rule; the JAX package has it too.
    B, T, L = thex.BLACK, thex.TOP, thex.BOT
    rows = [[0, 0, 0, 0, 0], [0, 0, B, 0, 0], [0, 0, B, 0, 0], [0, 0, L, B, 0], [0, 0, L, 0, 0]]
    board = np.array([rows], np.uint8)
    seats = np.zeros((1,), np.int32)
    tw = thex.Hex(board=torch.from_numpy(board), seats=torch.from_numpy(seats))
    jw = jhex.Hex(board=jnp.asarray(board), seats=jnp.asarray(seats))
    jw, tw, ttr = _step_both(jw, tw, np.array([[0, 2]], np.int32))
    assert tw.board[0].tolist() == [[0, 0, T, 0, 0], [0, 0, T, 0, 0], [0, 0, T, 0, 0],
                                    [0, 0, L, B, 0], [0, 0, L, 0, 0]]
    assert not bool(ttr.terminal[0])


def test_cpu_board_takes_the_twin(monkeypatch):
    # Hex.step on CPU tensors runs step_reference and never the kernel's
    # wrapper, for Hex and for the Solitaire worlds that step through it
    from boardlaw_tpu_torch.mcts import kernels

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU board reached the hex_step kernel")

    monkeypatch.setattr(kernels, "hex_step", refuse)
    n0 = kernels.launches["hex_step"]
    rng = np.random.default_rng(9)
    world = thex.Hex.initial(n_envs=8, boardsize=5, device="cpu")
    for _ in range(30):
        actions = torch.tensor([rng.choice(np.flatnonzero(v)) for v in world.valid.numpy()])
        want = thex.step_reference(world.board, world.seats, actions)
        world, tr = world.step(actions)
        got = (world.board, world.seats, tr.rewards, tr.terminal)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    solitaire = thex.Random.initial(n_envs=8, boardsize=5, device="cpu")
    solitaire.step(torch.zeros(8, dtype=torch.int64), draws=Draws(0, "cpu"))
    assert kernels.launches["hex_step"] == n0


def _hex_step_inputs(S=5, B=3):
    return (torch.zeros((B, S, S), dtype=torch.uint8), torch.zeros((B,), dtype=torch.int32),
            torch.zeros((B,), dtype=torch.int64))


@pytest.mark.parametrize("case,match", [
    ("size", "1 to 11"),
    ("board_dtype", "^board must be uint8"),
    ("board_shape", "^board must be a contiguous"),
    ("seats_shape", "^seats must be contiguous"),
    ("seats_dtype", "^seats must be torch.int32"),
    ("actions_shape", "^actions must be contiguous"),
    ("actions_dtype", "^actions must be int32 or int64"),
    ("cpu", "^board must be a CUDA tensor"),
])
def test_hex_step_wrapper_refuses_bad_inputs(case, match):
    # the kernel's checks run before any launch, so they are testable
    # without a card; a good board on the CPU is refused last
    from boardlaw_tpu_torch.mcts import kernels

    board, seats, actions = _hex_step_inputs()
    bad = {
        "size": lambda: _hex_step_inputs(S=kernels.HEX_MAX_SIZE + 1),
        "board_dtype": lambda: (board.int(), seats, actions),
        "board_shape": lambda: (board[:, :, :4], seats, actions),
        "seats_shape": lambda: (board, seats[:2], actions),
        "seats_dtype": lambda: (board, seats.long(), actions),
        "actions_shape": lambda: (board, seats, actions[:, None]),
        "actions_dtype": lambda: (board, seats, actions.to(torch.int16)),
        "cpu": lambda: (board, seats, actions),
    }[case]()
    n0 = kernels.launches["hex_step"]
    with pytest.raises(ValueError, match=match):
        kernels.hex_step(*bad)
    assert kernels.launches["hex_step"] == n0


def test_initial_needs_a_device_choice():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is valid")
    with pytest.raises(RuntimeError):
        thex.Hex.initial(n_envs=1, boardsize=3)


def _board_string(rng, size, n_black):
    """A random ASCII board with `n_black` black stones and as many white
    ones or one fewer, indented and framed by blank lines as in tests."""
    cells = np.full(size * size, ".")
    n_white = max(n_black - int(rng.integers(0, 2)), 0)
    picks = rng.choice(size * size, n_black + n_white, replace=False)
    cells[picks[:n_black]] = "b"
    cells[picks[n_black:]] = "w"
    rows = ["    " + "".join(r) for r in cells.reshape(size, size)]
    return "\n" + "\n".join(rows) + "\n    "


@pytest.mark.parametrize("boardsize", [3, 5, 7, 9, 11])
def test_board_strings_match_jax(boardsize):
    rng = np.random.default_rng(400 + boardsize)
    for n_black in (0, 1, boardsize // 2 + 1, boardsize):
        s = _board_string(rng, boardsize, n_black)
        assert thex.board_size(s) == jhex.board_size(s) == boardsize
        np.testing.assert_array_equal(thex.board_actions(s), jhex.board_actions(s).reshape(-1, 2))
        tw, jw = thex.from_string(s, device="cpu"), jhex.from_string(s)
        np.testing.assert_array_equal(tw.board.numpy(), np.asarray(jw.board))
        np.testing.assert_array_equal(tw.seats.numpy(), np.asarray(jw.seats))
        assert tw.render(0) == jw.render(0)
    # the JAX package's own case (tests/test_hex.py), on the port
    world = thex.from_string("""
    bwb
    wbw
    ...
    """, device="cpu")
    assert world.board[0, 2].tolist() == [0, 0, 0] and int((world.board != 0).sum()) == 6
    assert thex.CHARS[thex.ORDS["T"]] == "T"
    with pytest.raises(ValueError):  # two more black stones than white ones
        thex.board_actions("bb.\n...\n...")


@pytest.mark.parametrize("boardsize", [3, 5, 7, 9, 11])
def test_render_matches_jax(boardsize):
    rng = np.random.default_rng(500 + boardsize)
    n_envs = 4
    jw = jhex.Hex.initial(n_envs=n_envs, boardsize=boardsize)
    tw = thex.Hex.initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    for _ in range(boardsize * boardsize // 2):
        valid = tw.valid.numpy()
        actions = np.array([rng.choice(np.flatnonzero(v)) for v in valid], np.int32)
        jw, _ = _jstep(jw, jnp.asarray(actions))
        tw, _ = tw.step(torch.from_numpy(actions))
    for e in range(n_envs):
        assert tw.render(e) == jw.render(e)


class _FedGumbel(Draws):
    """Draws whose Gumbel noise is `jax.random.gumbel(key, shape)` of the
    keys fed in, one key per draw."""

    def __init__(self):
        self.device = torch.device("cpu")
        self.keys = []

    def gumbel(self, shape):
        return torch.tensor(np.asarray(jax.random.gumbel(self.keys.pop(0), tuple(shape))))


_jsolitaire_step = jax.jit(lambda w, a, k: w.step(a, key=k))


@pytest.mark.parametrize("kind,boardsize", [("Lazy", 3), ("Lazy", 7), ("Random", 3),
                                            ("Random", 5), ("Random", 11)])
def test_solitaire_games_match_jax(kind, boardsize):
    rng = np.random.default_rng(600 + boardsize)
    n_envs = 16
    jw = getattr(jhex, kind).initial(n_envs=n_envs, boardsize=boardsize)
    tw = getattr(thex, kind).initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    assert tw.n_seats == jw.n_seats == 1
    draws = _FedGumbel()
    key = jax.random.PRNGKey(boardsize)
    n_terminal = 0
    for ply in range(2 * boardsize * boardsize):
        np.testing.assert_array_equal(tw.valid.numpy(), np.asarray(jw.valid))
        actions = np.array([rng.choice(np.flatnonzero(v)) for v in tw.valid.numpy()], np.int32)
        key, sub = jax.random.split(key)
        draws.keys.append(sub)
        jw, jtr = _jsolitaire_step(jw, jnp.asarray(actions), sub)
        tw, ttr = tw.step(torch.from_numpy(actions), draws=draws)
        assert type(tw) is getattr(thex, kind)
        np.testing.assert_array_equal(tw.board.numpy(), np.asarray(jw.board), err_msg=f"ply {ply}")
        np.testing.assert_array_equal(tw.seats.numpy(), np.asarray(jw.seats))
        assert (tw.seats == 0).all()  # the protagonist is always to move
        np.testing.assert_array_equal(ttr.terminal.numpy(), np.asarray(jtr.terminal))
        np.testing.assert_array_equal(ttr.rewards.numpy(), np.asarray(jtr.rewards))
        assert ttr.rewards.shape == (n_envs, 1)
        n_terminal += int(ttr.terminal.sum())
    assert n_terminal > 0
    assert len(draws.keys) == (0 if kind == "Random" else 2 * boardsize * boardsize)
    if kind == "Random":
        with pytest.raises(TypeError):
            tw.step(torch.zeros(n_envs, dtype=torch.int32))
    with pytest.raises(ValueError):
        thex.Solitaire.initial(1, 3, seat=1, device="cpu")


class _RecordedGumbel(Draws):
    """The port's draws, each Gumbel draw kept for the golden model."""

    def __init__(self, seed):
        super().__init__(seed, "cpu")
        self.last = None

    def gumbel(self, shape):
        self.last = super().gumbel(shape)
        return self.last


@pytest.mark.parametrize("kind", ["Lazy", "Random"])
@pytest.mark.parametrize("boardsize", [3, 5, 9])
def test_solitaire_matches_golden(boardsize, kind):
    rng = np.random.default_rng(700 + boardsize)
    n_envs = 8
    world = getattr(thex, kind).initial(n_envs=n_envs, boardsize=boardsize, device="cpu")
    draws = _RecordedGumbel(boardsize)
    golden = [GoldenHex(boardsize) for _ in range(n_envs)]
    for ply in range(2 * boardsize * boardsize):
        actions = [rng.choice(np.flatnonzero(g.valid())) for g in golden]
        world, transition = world.step(torch.tensor(actions), draws=draws)
        for e, g in enumerate(golden):
            terminal, rewards = g.step(actions[e])
            if not terminal:  # the opponent: its first valid cell, or its draw
                valid = g.valid()
                if kind == "Lazy":
                    opp_action = int(np.flatnonzero(valid)[0])
                else:
                    opp_action = int(np.argmax(np.where(valid, 0.0, -np.inf)
                                               + draws.last[e].numpy()))
                terminal, opp = g.step(opp_action)
                rewards = rewards + opp
            assert bool(transition.terminal[e]) == terminal, (e, ply)
            assert float(transition.rewards[e, 0]) == rewards[0]
            np.testing.assert_array_equal(world.obs[e].numpy(), g.obs())
