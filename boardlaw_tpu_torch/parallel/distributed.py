"""Multi-process data parallelism: `torch.distributed` wiring.
Counterpart of boardlaw_tpu/parallel/distributed.py.

The JAX package connects N host processes into one JAX runtime whose
devices form one global mesh. Here every rank is a process with one
device, joined into a `torch.distributed` process group; `mesh.make_mesh`
gives its place in the world, and `train.run(n_devices=n)` spawns n ranks
through `launch`.

Process wiring comes from FLEET_* env vars, as in the JAX package, so
`fleet` machines can launch workers like any other job:

    FLEET_COORD      coordinator address host:port (rank 0 hosts it)
    FLEET_NUM_PROCS  world size
    FLEET_PROC_ID    this process's rank
    FLEET_DEVICE     this rank's device (`worker_main`; the card by default)
"""
from __future__ import annotations

import datetime
import json
import os
import pathlib
import queue
import socket
import time
import traceback
from logging import getLogger

import torch
import torch.distributed as dist

from ..utils import resolve_device

log = getLogger(__name__)

_DEVICE = None


def local_device():
    """This rank's device, as `initialize` chose it."""
    if _DEVICE is None or not dist.is_initialized():
        raise RuntimeError("this process has joined no world: call distributed.initialize")
    return _DEVICE


def initialize(coordinator=None, num_processes=None, process_id=None, device=None, backend=None,
               timeout=300):
    """Join this process to the data-parallel world. Returns the
    (num_processes, process_id) used.

    The arguments default to the FLEET_* variables. `device` is this rank's
    device; by default card `process_id % n_cards`. The JAX package's
    `local_device_count` made N virtual CPU devices a process; the port
    runs one rank a device, so a world of N devices is N processes (on the
    CPU, `device="cpu"` in each).

    `backend` defaults to 'nccl' where the ranks take a card each (`device`
    left to the default, at least as many visible cards as processes), and
    to 'gloo' on the CPU and for a device given explicitly, which other
    ranks may share (NCCL refuses two ranks on one card; gloo reduces CUDA
    tensors through the host). `timeout` (s) bounds every collective, so a
    rank whose peer died fails instead of waiting for ever."""
    global _DEVICE
    coordinator = coordinator or os.environ.get("FLEET_COORD")
    if num_processes is None and os.environ.get("FLEET_NUM_PROCS"):
        num_processes = int(os.environ["FLEET_NUM_PROCS"])
    if process_id is None and os.environ.get("FLEET_PROC_ID"):
        process_id = int(os.environ["FLEET_PROC_ID"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator, the world size and the rank "
                         "(arguments or FLEET_COORD, FLEET_NUM_PROCS, FLEET_PROC_ID)")
    own_cards = False
    if device is None:
        n_cards = torch.cuda.device_count()
        device = f"cuda:{process_id % max(n_cards, 1)}"
        own_cards = num_processes <= n_cards
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if own_cards else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    _DEVICE = device
    log.info(f"distributed: rank {process_id}/{num_processes} on {device} over {backend}")
    return num_processes, process_id


def shutdown():
    """Leave the world."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None


def free_port():
    """A free TCP port on localhost for a world's coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, device, fn, args, results):
    try:
        if device is not None and torch.device(device).type == "cpu":
            torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // n)))
        initialize(f"localhost:{port}", n, rank, device=device)
        from .mesh import make_mesh

        out = fn(make_mesh(n), *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def launch(fn, n_processes, device=None, args=(), timeout=None):
    """Run ``fn(mesh, *args)`` in `n_processes` spawned ranks of a fresh
    world on localhost; returns their results in rank order (each must
    pickle: tensors go as numpy). `fn` is a module-level function.

    `device`: None puts rank r on card r; 'cpu' every rank on the CPU; a
    card ('cuda:0') every rank on that card, over gloo. A rank that raises
    or dies ends the others and raises RuntimeError here with its
    traceback; past `timeout` seconds (None: no limit) every rank is ended
    and TimeoutError raised."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, n_processes, port, device, fn, args, results))
             for r in range(n_processes)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out = {}
    try:
        while len(out) < n_processes:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:  # look at the ranks
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    try:  # a failing rank's traceback may still be in flight
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"the {n_processes} ranks took more than {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:  # a rank that has returned only leaves its world
            p.join(60.0 if deadline is None else max(deadline - time.monotonic(), 1.0))
            if p.exitcode is None:
                raise TimeoutError("a rank did not exit after returning its result")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(n_processes)]


def global_state(state, mesh):
    """Place a whole `TrainState` that every process computed alike (the
    same seed) on the mesh: `mesh.shard_train_state`."""
    from .mesh import shard_train_state

    return shard_train_state(state, mesh)


def worker_demo(boardsize=3, width=4, depth=1, envs_per_device=2, seed=0):
    """One sharded train step over the world: the payload of the
    multi-process tests. Every rank mixes the whole batch's worlds from
    `Draws(seed)`, keeps its block, then warms up and steps through the
    sharded view of the same draws. Returns a JSON-able summary."""
    from ..draws import Draws
    from ..train import TrainConfig, make_train
    from .mesh import make_mesh

    mesh = make_mesh()
    n = mesh.size
    cfg = TrainConfig(boardsize=boardsize, width=width, depth=depth,
                      n_envs=envs_per_device * n, buffer_len=4, n_nodes=4, mix_steps=4, seed=seed)
    _, _, init, warmup, train_step = make_train(cfg, device=mesh.device)
    draws = Draws(cfg.seed, mesh.device)
    state = global_state(init(draws), mesh)
    draws = draws.shard(mesh.rank, n)
    state = warmup(state, draws)
    state, aux = train_step(state, draws)
    return {"process": mesh.rank, "n_processes": n, "n_devices": n,
            "loss": float(aux["loss.total"]), "step": int(state.step)}


def worker_main():
    """Entry point of fleet-launched workers: join the world from the
    FLEET_* variables, run the demo payload, write
    output/result-{rank}.json."""
    initialize(device=os.environ.get("FLEET_DEVICE") or None)
    try:
        out = worker_demo()
    finally:
        shutdown()
    pathlib.Path("output").mkdir(exist_ok=True)
    with open(f"output/result-{out['process']}.json", "w") as f:
        json.dump(out, f)
    print(json.dumps(out))


if __name__ == "__main__":
    # the package's copy of this module, whose state `mesh.make_mesh` reads
    from boardlaw_tpu_torch.parallel import distributed

    distributed.worker_main()
