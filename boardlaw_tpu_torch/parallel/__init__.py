"""Data-parallel training over ranks of a process group. Counterpart of
boardlaw_tpu/parallel/."""
from .mesh import make_mesh, shard_train_state, env_sharding, replicated  # noqa: F401
from . import distributed  # noqa: F401
