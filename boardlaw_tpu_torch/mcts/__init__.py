from .search import (  # noqa: F401
    MCTSConfig,
    Tree,
    MCTSAgent,
    DummyAgent,
    mcts,
    build,
    initialize,
    root,
    n_leaves,
    solve_policy,
    dirichlet_noise,
)
