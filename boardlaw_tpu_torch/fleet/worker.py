"""Job-side entry point: parse FLEET_PARAMS and run training. Counterpart of
boardlaw_tpu/fleet/worker.py.

    FLEET_PARAMS='{"boardsize": 9, "width": 64, "depth": 1}' FLEET_DEVICES=0 \\
        python -m boardlaw_tpu_torch.fleet.worker

One difference from the JAX worker, which runs on a TPU: a job's cards
(FLEET_DEVICES, as the scheduler allocated them) become
CUDA_VISIBLE_DEVICES before torch loads, so two jobs on one machine train
on two cards. The allocation's indices count the cards the scheduler
itself sees: where it inherited CUDA_VISIBLE_DEVICES, index i is that
list's i-th entry, as in `utils.parallel.visible_cards`; an empty
FLEET_DEVICES leaves the variable as it is. The worker prints its params,
the device `train.run` trains on (the card's name and UUID, or `cpu`),
and after the run one JSON line of the kernels' launch counts.
"""
from __future__ import annotations

import json
import os


def pin_devices(environ=os.environ):
    """Set CUDA_VISIBLE_DEVICES to the job's FLEET_DEVICES where that is set
    and not empty, each index taken into the inherited CUDA_VISIBLE_DEVICES
    where that is set; returns the variable as it then is. An index the
    inherited list lacks raises ValueError."""
    devices = environ.get("FLEET_DEVICES", "")
    if devices:
        ids = [i.strip() for i in devices.split(",")]
        inherited = environ.get("CUDA_VISIBLE_DEVICES")
        if inherited is not None:
            cards = [c.strip() for c in inherited.split(",") if c.strip()]
            if not all(i.isdigit() and int(i) < len(cards) for i in ids):
                raise ValueError(f"FLEET_DEVICES={devices!r} names cards outside the "
                                 f"inherited CUDA_VISIBLE_DEVICES={inherited!r}")
            ids = [cards[int(i)] for i in ids]
        environ["CUDA_VISIBLE_DEVICES"] = ",".join(ids)
    return environ.get("CUDA_VISIBLE_DEVICES")


def device_label(device):
    """The device a job trains on, as its log names it: the card's name and
    UUID, or `cpu`."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    return f"{props.name} (card {props.uuid})"


def main():
    pin_devices()
    params = json.loads(os.environ.get("FLEET_PARAMS", "{}"))
    print(f"fleet worker: {params}", flush=True)

    from .. import train
    from ..mcts import kernels
    from ..utils import resolve_device

    device = resolve_device(params.get("device"))
    print(f"fleet worker: training on {device_label(device)}", flush=True)
    train.run(**params)
    print(json.dumps({"kernels.launches": kernels.launches}), flush=True)


if __name__ == "__main__":
    main()
