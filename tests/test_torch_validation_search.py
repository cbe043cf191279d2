"""The search cases of tests/test_mcts.py (`test_trivial`, `test_two_player`,
`test_depth`, `test_multienv`, with two seats and the prisoner's dilemma
besides) on the port's search, over the planted-value games of
`envs/validation.py`, at K=1 and at K=8 with grow passes and in scan mode
(the JAX package's default K>1 mode). Each root value is held against the
analytic one (the JAX tests' values, to 1e-5; where every backed-up value is
the planted one, the root's mean value too), and each tree against the JAX
package's XLA search by the same route under the same draws: children,
parents and visit counts equal, values to 1e-5. The helpers are tests/test_torch_validation.py's.
"""
import numpy as np
import pytest
import torch

from boardlaw_tpu_torch.mcts import kernels
from test_torch_validation import ROUTES, SEARCHES, _hold_against_jax, _jax_search, _port_search

torch.set_num_threads(2)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(SEARCHES))
def test_search_cases_match_analytic_and_jax(case, route):
    value = SEARCHES[case][-1]
    counts = dict(kernels.launches)
    tt, troot = _port_search(case, route, seed=3)
    # on the CPU the wrappers run their twins and count no launch
    assert kernels.launches == counts
    np.testing.assert_allclose(troot["v"].numpy(), value, atol=1e-5)
    if case in ("trivial", "two_player"):  # every backed-up value is the planted one
        visits = tt.n[:, :1] / tt.w.shape[-1]  # `backup_n='seats'`: n counts S a visit
        np.testing.assert_allclose((tt.w[:, 0] / visits).numpy(), value, atol=1e-5)
    jt, jroot = _jax_search(case, route, 3)
    _hold_against_jax(tt, jt, troot, jroot)
