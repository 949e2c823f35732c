"""Multi-process execution of the distributed path (VERDICT r2 missing #3).

Everything multi-device elsewhere in the suite is single-process virtual
devices; this test actually runs `jax.distributed` as 2 OS processes x 4
virtual CPU devices each (the CPU stand-in for 2 hosts on DCN), through
`parallel/multihost.py`, and asserts parity of the cross-process psum
solves with their single-process references.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_parity():
    nproc = 2
    port = _free_port()
    env = dict(os.environ)
    # CPU with 4 virtual devices per process (2 processes x 4 = 8 global
    # devices)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_COORDINATOR_ADDRESS", None)
    repo_root = os.path.dirname(os.path.dirname(WORKER))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True, cwd=os.path.dirname(os.path.dirname(WORKER)),
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout={out}\nstderr={err[-4000:]}"

    # process 0 prints the parity JSON
    line = [l for l in outs[0][1].splitlines() if l.startswith("{")][-1]
    res = json.loads(line)
    assert res["process_count"] == 2
    assert res["device_count"] == 8
    # sharded dense BA across processes matches the single-process solve
    assert res["cams_err"] < 5e-3, res
    assert res["cost_rel"] < 1e-3, res
    # windowed global BA across processes matches the single-process path
    assert res["windows"] >= 2, res
    assert res["window_pose_err"] < 1e-3, res
