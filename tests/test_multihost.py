"""Simulated multi-host run: 2 processes x 2 CPU devices = one 4-device
global mesh, joined via parallel/mesh.init_distributed
(jax.distributed.initialize) with cross-process collectives.

The reference is single-node (SURVEY.md §2.8) — multi-host is added
capability; GPU hosts use the same code path with the coordinator,
process count and process id given explicitly."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_groupby():
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "multihost_worker.py")
    procs = [
        subprocess.Popen([sys.executable, worker, str(i), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=210)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{i} failed:\n{out[-2000:]}"
        assert f"proc{i} OK" in out
        assert f"proc{i} E2E OK" in out, f"proc{i} e2e failed:\n{out[-2000:]}"
        assert f"proc{i} DICT OK" in out, (
            f"proc{i} dict unification failed:\n{out[-2000:]}")
