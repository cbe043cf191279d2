"""The port's GTP plumbing (`mohex`) and the bundled engine (`gtp_engine`)
on the cases of tests/test_mohex.py and tests/test_gtp_engine.py: the
scripted stub engine (tests/gtp_stub.py) and the real compiled gtphex
engine, built by the port from the JAX package's C++ source. The SGF and
notation agree with the JAX package's string for string, and
`MoHexAgent`'s random blend takes its seed through `Draws.integer` where
JAX's draws it from its key, so under the same seed both agents play the
same moves."""
import os
import sys

import numpy as np
import jax
import pytest
import torch

from boardlaw_tpu import mohex as jmohex
from boardlaw_tpu.envs import hex as jhex
from boardlaw_tpu_torch import gtp_engine, mohex
from boardlaw_tpu_torch.arena import common, live
from boardlaw_tpu_torch.draws import Draws
from boardlaw_tpu_torch.envs import hex as thex

STUB = f"{sys.executable} {os.path.join(os.path.dirname(__file__), 'gtp_stub.py')}"


def _world(actions, boardsize=3):
    world = thex.Hex.initial(1, boardsize, device="cpu")
    for a in actions:
        world, _ = world.step(torch.tensor([a]))
    return world


@pytest.fixture(scope="module")
def engine():
    if not gtp_engine.available():
        pytest.skip("no C++ compiler for gtphex")
    return gtp_engine.command(seed=7)


class SeedDraws(Draws):
    """The seed JAX's MoHexAgent draws from `key`."""

    def __init__(self, key):
        self.device = torch.device("cpu")
        self.key = key

    def integer(self, high):
        return int(jax.random.randint(self.key, (), 0, high))


def test_notation_and_sgf_match_jax():
    assert mohex.to_notation((2, 3)) == jmohex.to_notation((2, 3)) == "d3"
    assert mohex.from_notation("d3") == jmohex.from_notation("d3") == (2, 3)
    for actions in ([4], [4, 2], [4, 2, 2], [6, 0, 5, 3, 8]):
        tw = _world(actions)
        jw = jhex.Hex.initial(1, 3)
        for a in actions:
            jw, _ = jw.step(jax.numpy.array([a]))
        seat = int(tw.seats[0])
        assert mohex.as_sgf(tw.obs[0].numpy(), seat) == jmohex.as_sgf(np.asarray(jw.obs[0]), seat)
    sgf = mohex.as_sgf(_world([4, 2, 2]).obs[0].numpy(), seat=1)
    assert "B[b2]" in sgf and "B[c1]" in sgf and "W[a3]" in sgf
    assert open(mohex.configfile(max_games=5)).read() == open(jmohex.configfile(max_games=5)).read()


def test_stub_conversation_and_agent():
    gtp = mohex.MoHex(command=STUB)
    gtp.boardsize(3)
    gtp.play("b", (0, 0))
    assert gtp.solve("w") == (0, 1)  # the first free cell after a1 is b1
    gtp.clear()
    assert gtp.solve("b") == (0, 0)
    gtp.close()
    # seat 1 acts in the transposed frame: the stub's b1 is action 3
    agent = mohex.MoHexAgent(command=STUB, max_proxies=1)
    world = _world([0])
    assert int(agent(world, Draws(0, "cpu"))["actions"][0]) == 3
    assert world.step(agent(world)["actions"])[0].board[0, 0, 1] in (thex.WHITE, thex.LEFT,
                                                                      thex.RIGHT)
    agent.close()
    # fully random: no engine process is started
    agent = mohex.MoHexAgent(command=STUB, max_proxies=2, random=1.0)
    world = thex.Hex.initial(2, 3, device="cpu")
    acts = agent(world, Draws(1, "cpu"))["actions"]
    assert world.valid[torch.arange(2), acts.long()].all() and agent._proxies == []


@pytest.mark.parametrize("random", [0.5, 1.0])
def test_random_blend_matches_jax(random):
    key = jax.random.PRNGKey(3)
    jagent = jmohex.MoHexAgent(command=STUB, max_proxies=4, random=random)
    tagent = mohex.MoHexAgent(command=STUB, max_proxies=4, random=random)
    jw = jhex.Hex.initial(4, 3)
    want = np.asarray(jagent(jw, key)["actions"])
    got = tagent(thex.Hex.initial(4, 3, device="cpu"), SeedDraws(key))["actions"]
    jagent.close()
    tagent.close()
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_conversation_and_immediate_wins(engine):
    gtp = mohex.MoHex(command=engine)
    gtp.boardsize(3)
    gtp.play("b", (0, 0))
    gtp.play("w", (1, 1))
    gtp.play("b", (1, 0))
    assert gtp.solve("b") == (2, 0)  # black completes a1-a2-a3
    gtp.clear()
    gtp.display()
    gtp.close()
    # white's unique immediate win at board (0,2), through the agent and env
    world = _world([6, 0, 5, 3, 8])
    agent = mohex.MoHexAgent(command=engine, max_proxies=1)
    decisions = agent(world, Draws(0, "cpu"))
    agent.close()
    assert int(decisions["actions"][0]) == 6
    _, transition = world.step(decisions["actions"])
    assert bool(transition.terminal[0]) and float(transition.rewards[0, 1]) == 1.0


def test_engine_self_play_and_external_ladder(engine):
    world = thex.Hex.initial(1, 5, device="cpu")
    agent = mohex.MoHexAgent(command=engine, max_proxies=1)
    draws = Draws(0, "cpu")
    for ply in range(26):
        a = agent(world, draws)["actions"]
        assert bool(world.valid[0, int(a[0])]), ply
        world, transition = world.step(a)
        if bool(transition.terminal[0]):
            assert sorted(transition.rewards[0].tolist()) == [-1.0, 1.0]
            break
    else:
        pytest.fail("no terminal state within 26 plies of 5x5 hex")
    agent.close()

    ladder = live.external_ladder(randoms=(1.0, 0.0), command=engine, max_proxies=2)
    assert set(ladder) == {"ext-1", "ext-0"}
    try:
        results = common.evaluate(thex.Hex.initial(2, 3, device="cpu"), ladder)
        assert sum(r["games"] for r in results) == 2
    finally:
        for a in ladder.values():
            a.close()
    if not mohex.available():  # the default ladder falls back to the bundled engine
        assert all(a._command == gtp_engine.command()
                   for a in live.external_ladder().values())
