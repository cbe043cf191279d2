"""The port's K>1 search through the split kernel routes against the JAX
package's Pallas routes in interpret mode, on 5x5 with B=8, n_nodes=13, K=4,
as tests/test_torch_search_scan.py (whose `run_case` this file shares) holds
the torch-ops routes:

* `solve_kernel='probs'` against `pallas_solve="interpret"`;
* `solve_kernel='alpha'` against `pallas_solve="alpha_interpret"`, in scan
  mode and with grow passes;
* `sample_kernel=True` against `pallas_sample="interpret"`.

On the CPU the port's wrappers run their twins and count no launch.
"""
import pytest

from boardlaw_tpu_torch.mcts import kernels
from test_torch_search_scan import run_case


@pytest.mark.parametrize("name,seed,plies,tkw,jkw", [
    ("probs", 45, 6, dict(solve_kernel="probs"), dict(pallas_solve="interpret")),
    ("alpha", 42, 8, dict(solve_kernel="alpha"), dict(pallas_solve="alpha_interpret")),
    ("sampler", 43, 5, dict(solve_kernel="ops", sample_kernel=True),
     dict(pallas_sample="interpret", pallas_sample_envs=8)),
    ("grow+alpha", 44, 7, dict(solve_kernel="alpha", grow_passes=True),
     dict(grow_passes=True, pallas_solve="alpha_interpret")),
])
def test_kernel_routes_match_pallas(monkeypatch, name, seed, plies, tkw, jkw):
    n0 = dict(kernels.launches)
    run_case(monkeypatch, seed, plies, tkw, jkw)
    assert kernels.launches == n0, name
