"""Fleet orchestration: farm training jobs out to machines. Counterpart of
boardlaw_tpu/fleet/, reading and writing the same registry.

A JSON job registry (`jobs`), machine plugins (`local` subprocesses, `ssh`
hosts; `machines`), a first-fit scheduler over each machine's cards with
liveness polling (`manage`), result fetching, and a dedupe-aware sweep
launcher (`sweep`) whose jobs run `python -m boardlaw_tpu_torch.fleet.worker`:
`train.run` with the job's FLEET_PARAMS, on the cards of its allocation.
"""
from . import jobs, machines, manage, local, sweep  # noqa: F401
from .jobs import submit  # noqa: F401
from .manage import refresh, fetch, cleanup  # noqa: F401
