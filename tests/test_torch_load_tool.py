"""tools/load_test_torch.py, the port's HTTP load tool, at tiny shapes on
the CPU: it spawns the port's server (--cpu), sets up, loads and stops it
with every read decode-verified; the JAX tool's client loop
(tools/load_test.py's run_load) reads the same way from a port server, so
the port's wire is held against the JAX package's client; the two tools'
gold values and summaries agree; the server is stopped on every exit path.

Nothing here depends on a short wall-clock window: each reader of the
port's tool starts one read at the start of the window, so reads >= clients
holds however slowly the readers run; that 16 readers coalesce
(max_batch >= 2) is chip_smoke's load phase's check, on the card."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import load_test            # noqa: E402  the JAX tool (imports no jax)
import load_test_torch      # noqa: E402

CLIENTS = 3


def check(summary: dict, clients: int = CLIENTS) -> None:
    assert summary["errors"] == 0, summary["error_samples"]
    assert summary["reads"] >= clients, summary
    assert summary["read_coalescer"]["requests"] >= summary["reads"], summary


@pytest.fixture(scope="module")
def port_server():
    """One --cpu port server for the module, without warm-up."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        proc, port = load_test_torch.spawn_server(10.0, cpu=True,
                                                  warmup=False)
    try:
        yield f"http://localhost:{port}"
    finally:
        load_test_torch.stop_server(proc)
    assert proc.poll() is not None


def spawned(monkeypatch) -> list:
    """Record the processes the tool spawns."""
    procs = []
    popen = subprocess.Popen

    def record(*args, **kwargs):
        procs.append(popen(*args, **kwargs))
        return procs[-1]

    monkeypatch.setattr(load_test_torch.subprocess, "Popen", record)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return procs


def test_tool_spawns_loads_and_stops_the_port_server(monkeypatch):
    """The tool's own path: spawn a --cpu port server (its port from the
    "Listening on" line), warm it, 3 readers and the writer, then stop it."""
    procs = spawned(monkeypatch)
    summary = load_test_torch.main([
        "--cpu", "--clients", str(CLIENTS), "--duration", "2",
        "--window-ms", "50", "--n-keys", "8", "--writer"])
    check(summary)
    assert all(v is not None and v >= 0
               for v in summary["client_ms"].values()), summary["client_ms"]
    assert summary["mean_coalesced_batch"] >= 1
    assert len(procs) == 1 and procs[0].poll() is not None
    assert "--cpu" in procs[0].args and procs[0].args[3] == "0"


def test_jax_tool_client_loop_reads_from_the_port_server(port_server):
    """tools/load_test.py's run_load (the JAX package's Bucket client)
    against the port's server: every read decodes to the gold value."""
    check(load_test.run_load(port_server, CLIENTS, 2.0, n_keys=8, seed=1))


def test_summary_keys_are_a_superset_of_the_jax_tools(port_server):
    jax_keys = set(load_test.run_load(port_server, 1, 0.5, n_keys=4,
                                      seed=2))
    summary = load_test_torch.run_load(port_server, 1, 0.5, n_keys=4, seed=3)
    check(summary, 1)
    assert jax_keys <= set(summary), jax_keys - set(summary)
    assert set(summary["client_ms"]) == set(load_test_torch.CLIENT_PARTS)


@pytest.mark.parametrize("key,size", [("load-0-0", 64), ("churn-0-71", 64),
                                      ("", 64), ("k", 7), ("x" * 100, 200)])
def test_gold_values_equal_the_jax_tools(key, size):
    assert load_test_torch.key_to_gold_value(key, size) \
        == load_test.key_to_gold_value(key, size)


@pytest.mark.parametrize("fault", ["load", "restore", "no_card"])
def test_server_stopped_on_error(monkeypatch, tmp_path, fault):
    """A run that raises, a server that fails to start (a checkpoint
    directory that does not exist), and a server spawned without --cpu
    where there is no card (it runs on the card or not at all) leave no
    server process behind."""
    procs = spawned(monkeypatch)
    match = "server did not start"
    if fault == "load":
        def fail(*args, **kwargs):
            raise RuntimeError("load failed")

        monkeypatch.setattr(load_test_torch, "run_load", fail)
        args, match = ["--cpu", "--no-warmup"], "load failed"
    elif fault == "restore":
        args = ["--cpu", "--no-warmup", "--restore", str(tmp_path / "none")]
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        args = ["--no-warmup"]
    with pytest.raises(RuntimeError, match=match):
        load_test_torch.main(args + ["--clients", "1", "--duration", "1"])
    assert len(procs) == 1 and procs[0].poll() is not None


def test_spawned_server_command():
    """The spawned server's command line: port 0, the store's params and
    the checkpoint passed through, warmed, and no --cpu unless asked."""
    cmd = load_test_torch.server_command(25.0, False, ["15", "32768"], True,
                                         "ckpt")
    assert "--cpu" not in cmd and cmd[3:6] == ["0", "15", "32768"]
    assert cmd[cmd.index("--restore") + 1] == "ckpt" and "--warmup" in cmd
