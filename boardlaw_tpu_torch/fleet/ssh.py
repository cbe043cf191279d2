"""SSH machine plugin: jobs run on a remote host over ssh/scp/rsync.
Counterpart of boardlaw_tpu/fleet/ssh.py.

The archive goes up by scp, the command runs under `nohup` in a bash that
echoes its pid, liveness is `ps -p`, and the output comes back by rsync. It
uses the system's ssh client and no Python package; the spec's config
carries `host` (the ssh destination) and optionally `ssh_args` and
`workdir`.
"""
from __future__ import annotations

import json
import shlex
import subprocess
from pathlib import Path

from . import jobs


class Machine:
    def __init__(self, spec):
        self.spec = spec
        self.name = spec.name
        self.resources = spec.resources
        self.host = spec.config["host"]
        self.ssh_args = spec.config.get("ssh_args", [])
        self.workdir = spec.config.get("workdir", "~/.fleet")

    def _ssh(self, cmd, **kwargs):
        return subprocess.run(
            ["ssh", *self.ssh_args, self.host, cmd],
            capture_output=True, text=True, **kwargs,
        )

    def launch(self, job, allocation):
        remote = f"{self.workdir}/{job.name}"
        self._ssh(f"mkdir -p {remote}")
        subprocess.run(
            ["scp", *self.ssh_args, job.archive, f"{self.host}:{remote}/code.tar.gz"],
            check=True, capture_output=True,
        )
        devices = ",".join(str(x) for x in allocation.get("devices", []))
        params = shlex.quote(json.dumps(job.params))
        inner = (
            f"cd {remote} && tar xzf code.tar.gz && "
            f"export FLEET_NAME={shlex.quote(job.name)} FLEET_PARAMS={params} FLEET_DEVICES={devices} && "
            f"nohup {job.command} > fleet-out.log 2>&1 & echo $!"
        )
        r = self._ssh(f"bash -c {shlex.quote(inner)}")
        return int(r.stdout.strip().splitlines()[-1])

    def alive(self, job):
        r = self._ssh(f"ps -p {job.pid} -o pid=")
        return bool(r.stdout.strip())

    def fetch(self, job, target="output"):
        remote = f"{self.workdir}/{job.name}/output/"
        Path(target).mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["rsync", "-az", "-e", " ".join(["ssh", *self.ssh_args]) or "ssh",
             f"{self.host}:{remote}", f"{target}/"],
            capture_output=True,
        )

    def cleanup(self, job):
        self._ssh(f"rm -rf {self.workdir}/{job.name}")

    def tail(self, job, n=20):
        r = self._ssh(f"tail -n {n} {self.workdir}/{job.name}/fleet-out.log")
        return r.stdout
