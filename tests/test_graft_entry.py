"""Regression tests for the driver entry points in ``__graft_entry__``.

``dryrun_multichip(8)`` may be called from a process with one device (an
accelerator, or a plain CPU run) — an earlier version assumed the caller
pre-provisioned the 8-device mesh and crashed.  These tests pin the
self-provisioning contract: with insufficient in-process devices it must
re-exec in a subprocess with a forced CPU device count rather than crash.
"""
import sys
from pathlib import Path

import jax

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import __graft_entry__  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = __graft_entry__.entry()
    out = jax.jit(fn)(*args)
    assert all(v is not None for v in jax.tree_util.tree_leaves(out))


def test_dryrun_in_process_with_enough_devices():
    # conftest forces 8 virtual CPU devices, so this takes the in-process
    # path and executes every parallelism assertion (dp/tp/sp/ep/pp).
    assert len(jax.devices()) >= 8
    __graft_entry__.dryrun_multichip(8)


def test_dryrun_self_provisions_when_devices_insufficient(monkeypatch):
    # Simulate the driver's environment: more devices requested than the
    # process has.  Must take the subprocess route and succeed, not raise
    # the round-1 reshape ValueError.
    calls = {}
    real_run = __graft_entry__.dryrun_multichip

    import subprocess

    orig_sub = subprocess.run

    def spy_run(*args, **kwargs):
        calls["argv"] = args[0]
        calls["env"] = kwargs.get("env", {})
        return orig_sub(*args, **kwargs)

    monkeypatch.setattr(subprocess, "run", spy_run)
    real_run(16)  # more than the 8 virtual devices -> subprocess path
    assert "--xla_force_host_platform_device_count=16" in \
        calls["env"]["XLA_FLAGS"]
    assert calls["env"]["JAX_PLATFORMS"] == "cpu"
