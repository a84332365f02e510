"""The port's examples (examples/torch_0*.py) must stay runnable on the
CPU: each asserts its own claims, so a clean exit is the check.  They
run in a fresh interpreter, with --cpu (on the card without it)."""

import os
import subprocess
import sys

import pytest

from helpers import cpu_child_env

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize(
    "script",
    [
        "torch_01_offline_upmix.py",
        "torch_02_streaming_checkpoint.py",
        "torch_03_multichip_sharded.py",
        "torch_04_serving.py",
    ],
)
def test_example_runs(script, tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), str(tmp_path), "--cpu"],
        capture_output=True, text=True, env=cpu_child_env(), timeout=300, cwd=ROOT,
    )
    assert r.returncode == 0, r.stdout[-800:] + r.stderr[-1500:]
    assert "jax" not in r.stderr.lower()
