"""Host abstraction for dispatching shard children.

A :class:`Host` turns an argv (``python -m repro_torch.dist.shard_child ...``)
into a running process and hands back a :class:`Handle` the supervisor
polls/kills.  Two implementations:

* :class:`LocalProcessHost` — plain subprocesses on this machine (the CI
  chaos harness and single-box multi-core sweeps);
* :class:`ShellCommandHost` — a ``{cmd}`` template wrapped around the
  command line, covering SSH/SLURM-style dispatch (``"ssh dse-03
  {cmd}"``, ``"srun -p batch {cmd}"``) without this module knowing
  anything about the transport.  Environment overrides are folded into
  the command as POSIX ``K=V`` prefixes so they survive the remote hop.

Launches go through :func:`repro_torch.dist.retrying.retry_call` — a
transient spawn failure (fork pressure, ssh connection reset) retries with
deterministic jittered backoff instead of failing the whole sweep.

Note the kill asymmetry the supervisor's re-shard protocol is designed
around: ``LocalProcessHost`` kills reach the child, but a
``ShellCommandHost`` kill only reaches the *local* wrapper — the remote
process may linger and keep appending to its checkpoint.  That is why a
declared-dead shard's replacement jobs always write **fresh** checkpoint
files (see ``supervisor.py``): a zombie writer can race the merge only
with records the per-task seed gate makes identical anyway.

Copy of ``src/repro/dist/hosts.py``; the children are ``python -m
repro_torch.dist.shard_child`` with this checkout's ``src`` on
``PYTHONPATH``.
"""

from __future__ import annotations

import os
import shlex
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Protocol, Sequence, Union

from .retrying import RetryPolicy, retry_call

# spawn-time policy: quick, bounded — a host that cannot spawn after 4
# tries is genuinely sick and should surface as a launch failure
LAUNCH_RETRY = RetryPolicy(max_attempts=4, base_s=0.05, factor=2.0,
                           max_s=2.0, retryable=(OSError,))


class Handle(Protocol):
    """A launched shard process, as seen by the supervisor."""

    def poll(self) -> Optional[int]:
        """Exit code, or None while still running."""
        ...

    def kill(self) -> None:
        ...

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        ...


class Host(Protocol):
    """Anything that can run a shard child and report liveness."""

    name: str

    def launch(self, argv: Sequence[str], env: Dict[str, str],
               log_path: Union[str, Path, None] = None) -> Handle:
        """Start ``argv`` with ``env`` overrides; stdout+stderr to
        ``log_path`` when given."""
        ...


class _PopenHandle:
    """Thin adapter closing the log file with the process."""

    def __init__(self, proc: subprocess.Popen, log_file=None):
        self._proc = proc
        self._log = log_file

    @property
    def pid(self) -> int:
        return self._proc.pid

    def poll(self) -> Optional[int]:
        rc = self._proc.poll()
        if rc is not None:
            self._close_log()
        return rc

    def kill(self) -> None:
        try:
            self._proc.kill()
            self._proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass
        self._close_log()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            rc = self._proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        self._close_log()
        return rc

    def _close_log(self) -> None:
        if self._log is not None:
            try:
                self._log.close()
            except OSError:
                pass
            self._log = None


def _child_env(env: Dict[str, str]) -> Dict[str, str]:
    """Full child environment: inherited, PYTHONPATH guaranteed to reach
    this checkout's ``src`` (the child is ``python -m repro_torch...``),
    overrides last."""
    full = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    pp = full.get("PYTHONPATH", "")
    if src not in pp.split(os.pathsep):
        full["PYTHONPATH"] = f"{src}{os.pathsep}{pp}" if pp else src
    full.update(env)
    return full


class LocalProcessHost:
    """Launch shard children as subprocesses of this machine."""

    def __init__(self, name: str = "local", python: Optional[str] = None,
                 retry_seed: int = 0):
        self.name = name
        self.python = python or sys.executable
        self.retry_seed = retry_seed

    def launch(self, argv: Sequence[str], env: Dict[str, str],
               log_path: Union[str, Path, None] = None) -> _PopenHandle:
        cmd = [self.python, *argv]
        log = None
        if log_path is not None:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)
            log = open(log_path, "ab")

        def spawn() -> subprocess.Popen:
            return subprocess.Popen(
                cmd, env=_child_env(env),
                stdout=log or subprocess.DEVNULL,
                stderr=subprocess.STDOUT if log else subprocess.DEVNULL)

        try:
            proc = retry_call(spawn, policy=LAUNCH_RETRY,
                              seed=self.retry_seed,
                              label=f"launch@{self.name}")
        except BaseException:
            if log is not None:
                log.close()
            raise
        return _PopenHandle(proc, log)

    def __repr__(self) -> str:
        return f"LocalProcessHost({self.name!r})"


class ShellCommandHost:
    """Dispatch through a shell-command template (SSH/SLURM style).

    ``template`` must contain ``{cmd}``; the child's command line —
    ``K=V`` env prefixes included — is quoted and substituted, then the
    whole thing runs under ``sh -c`` locally.  ``"{cmd}"`` is therefore
    a LocalProcessHost-equivalent loopback, which is what the tests and
    the CI chaos job use; real deployments pass ``"ssh <host> {cmd}"``.
    """

    def __init__(self, template: str, name: Optional[str] = None,
                 python: str = "python", retry_seed: int = 0):
        if "{cmd}" not in template:
            raise ValueError(
                f"host template {template!r} must contain '{{cmd}}'")
        self.template = template
        self.name = name or template.replace("{cmd}", "").strip() or "shell"
        self.python = python
        self.retry_seed = retry_seed

    def launch(self, argv: Sequence[str], env: Dict[str, str],
               log_path: Union[str, Path, None] = None) -> _PopenHandle:
        # POSIX `K=V cmd` prefixes ride the template to the remote side
        prefix = " ".join(f"{k}={shlex.quote(v)}"
                          for k, v in sorted(env.items()))
        src = str(Path(__file__).resolve().parents[2])
        prefix = f"PYTHONPATH={shlex.quote(src)} {prefix}".strip()
        cmd = " ".join([prefix, self.python,
                        *(shlex.quote(a) for a in argv)]).strip()
        full = self.template.format(cmd=cmd)
        log = None
        if log_path is not None:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)
            log = open(log_path, "ab")

        def spawn() -> subprocess.Popen:
            return subprocess.Popen(
                ["/bin/sh", "-c", full],
                stdout=log or subprocess.DEVNULL,
                stderr=subprocess.STDOUT if log else subprocess.DEVNULL)

        try:
            proc = retry_call(spawn, policy=LAUNCH_RETRY,
                              seed=self.retry_seed,
                              label=f"launch@{self.name}")
        except BaseException:
            if log is not None:
                log.close()
            raise
        return _PopenHandle(proc, log)

    def __repr__(self) -> str:
        return f"ShellCommandHost({self.template!r})"


def parse_hosts(specs: Sequence[str], n_local: int = 0) -> List[Host]:
    """CLI helper: ``--host`` template strings + ``--hosts N`` local
    process slots into a host list (at least one)."""
    hosts: List[Host] = [ShellCommandHost(s, name=f"shell{i}",
                                          retry_seed=i)
                         for i, s in enumerate(specs)]
    hosts += [LocalProcessHost(name=f"local{i}", retry_seed=100 + i)
              for i in range(n_local)]
    if not hosts:
        hosts = [LocalProcessHost()]
    return hosts
