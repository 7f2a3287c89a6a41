"""Remote job deployment: ``Job`` and ``Punchcard``.

Counterpart of ``distkeras_tpu/deployment.py`` (the reference's
``distkeras/job_deployment.py``): ``Job`` ships a data file and a training
script to a machine over ``scp``, runs it there over ``ssh`` and fetches
artifacts back; ``Punchcard`` runs a JSON list of such jobs in turn. With
``address=None`` a job runs locally, staged the same way. Nothing here
touches a device: the script picks its own (the port's entry points run on
the card unless asked for the CPU).

- ``Job``: copy inputs, run ``python <script> [args]`` in the job's
  directory, fetch named outputs.
- ``Punchcard``: read a JSON list of job specs and run them sequentially.
"""

from __future__ import annotations

import json
import os
import shlex
import subprocess
from typing import Any

__all__ = ["Job", "Punchcard"]


class Job:
    """One remote training job (reference ``job_deployment.py`` § ``Job``).

    Parameters mirror the reference: job name, address of the target
    machine, username, paths of the data and script to ship, and where
    results land. ``args`` go to the script's command line; ``python`` is
    the interpreter that runs it on the target; ``timeout`` (seconds, None:
    none) bounds the run, and a run past it raises
    ``subprocess.TimeoutExpired``.
    """

    def __init__(
        self,
        job_name: str,
        address: str | None,
        username: str | None = None,
        data_path: str | None = None,
        script_path: str | None = None,
        remote_dir: str = "~/distkeras_jobs",
        fetch: tuple[str, ...] = (),
        env: dict[str, str] | None = None,
        args: tuple[str, ...] = (),
        python: str = "python",
        timeout: float | None = None,
    ):
        self.job_name = job_name
        self.address = address
        self.username = username
        self.data_path = data_path
        self.script_path = script_path
        self.remote_dir = remote_dir
        self.fetch = tuple(fetch)
        self.env = dict(env or {})
        self.args = tuple(str(a) for a in args)
        self.python = python
        self.timeout = timeout
        self.returncode: int | None = None
        self.output: str = ""

    # -- internals -----------------------------------------------------------

    def _target(self) -> str:
        return f"{self.username}@{self.address}" if self.username else self.address

    def _run(self, argv: list[str], timeout: float | None = None) -> subprocess.CompletedProcess:
        return subprocess.run(argv, capture_output=True, text=True, timeout=timeout)

    def _remote_job_dir(self) -> str:
        return f"{self.remote_dir}/{self.job_name}"

    # -- lifecycle (reference: send -> execute -> fetch) ---------------------

    def send(self) -> None:
        """Ship data and script to the target (scp), or stage locally (same
        layout the remote path establishes: inputs sit next to the script)."""
        if self.address is None:
            import shutil

            os.makedirs(self._local_dir(), exist_ok=True)
            for p in filter(None, (self.data_path, self.script_path)):
                # raise the real error here, not a confusing missing-file
                # failure later in execute()
                if os.path.isdir(p):
                    shutil.copytree(
                        p,
                        os.path.join(self._local_dir(), os.path.basename(p)),
                        dirs_exist_ok=True,
                    )
                else:
                    shutil.copy2(p, self._local_dir())
            return
        self._run(["ssh", self._target(), f"mkdir -p {self._remote_job_dir()}"])
        for p in filter(None, (self.data_path, self.script_path)):
            r = self._run(["scp", "-q", p, f"{self._target()}:{self._remote_job_dir()}/"])
            if r.returncode != 0:
                raise RuntimeError(f"scp failed for {p}: {r.stderr.strip()}")

    def _local_dir(self) -> str:
        return os.path.expanduser(f"{self.remote_dir}/{self.job_name}".replace("~", os.path.expanduser("~")))

    def execute(self) -> int:
        """Run the script (remotely over ssh, or locally with address=None)."""
        if self.script_path is None:
            raise ValueError("Job has no script_path")
        env_prefix = " ".join(
            f"{k}={shlex.quote(v)}" for k, v in self.env.items()
        )
        script_name = os.path.basename(self.script_path)
        argv = " ".join(shlex.quote(a) for a in (script_name, *self.args))
        if self.address is None:
            # run the staged copy by name, mirroring the remote layout
            cmd = (
                f"cd {shlex.quote(self._local_dir())} && {env_prefix} "
                f"{shlex.quote(self.python)} {argv}"
            )
            r = subprocess.run(["bash", "-c", cmd], capture_output=True, text=True,
                               timeout=self.timeout)
        else:
            remote_cmd = (
                f"cd {self._remote_job_dir()} && {env_prefix} {shlex.quote(self.python)} {argv}"
            )
            r = self._run(["ssh", self._target(), remote_cmd], timeout=self.timeout)
        self.returncode = r.returncode
        self.output = r.stdout + r.stderr
        return self.returncode

    def fetch_artifacts(self, local_dir: str) -> list[str]:
        os.makedirs(local_dir, exist_ok=True)
        fetched = []
        for name in self.fetch:
            if self.address is None:
                src = os.path.join(self._local_dir(), name)
                if os.path.exists(src):
                    dst = os.path.join(local_dir, name)
                    subprocess.run(["cp", "-r", src, dst], check=False)
                    fetched.append(dst)
            else:
                dst = os.path.join(local_dir, name)
                r = self._run(
                    ["scp", "-rq", f"{self._target()}:{self._remote_job_dir()}/{name}", dst]
                )
                if r.returncode == 0:
                    fetched.append(dst)
        return fetched

    def run(self, local_artifact_dir: str | None = None) -> int:
        """send -> execute -> fetch, returning the exit code."""
        self.send()
        code = self.execute()
        if local_artifact_dir:
            self.fetch_artifacts(local_artifact_dir)
        return code


class Punchcard:
    """Batch job runner from a JSON spec file (reference
    ``job_deployment.py`` § ``Punchcard``).

    Spec format: ``{"jobs": [{"job_name": ..., "address": ...,
    "script_path": ..., ...}, ...]}`` — keys are :class:`Job` kwargs.
    """

    def __init__(self, path: str):
        with open(path) as f:
            self.spec: dict[str, Any] = json.load(f)
        if "jobs" not in self.spec or not isinstance(self.spec["jobs"], list):
            raise ValueError("punchcard spec needs a top-level 'jobs' list")
        self.jobs = [Job(**j) for j in self.spec["jobs"]]

    def run(self, stop_on_failure: bool = True) -> list[int]:
        codes = []
        for job in self.jobs:
            codes.append(job.run())
            if codes[-1] != 0 and stop_on_failure:
                break
        return codes
