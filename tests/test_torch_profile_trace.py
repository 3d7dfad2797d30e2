"""The port's torch.profiler hook (sdk_tpu_torch.telemetry.profile_trace) and
tools/profile_trace_torch.py on the CPU: the hook writes a Chrome trace;
the tool's reading of a trace (windows, the device's busy time and idle
share, host gaps between hand launches) on a trace made by hand; and the
tool's tiny CPU mode end to end in a process that refuses jax."""

import json
import os
import subprocess
import sys

import torch

from sdk_tpu_torch.telemetry import profile_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import profile_trace_torch as tool  # noqa: E402

torch.set_num_threads(1)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "t"), cuda=False) as prof:
        with torch.profiler.record_function("read"):
            x = torch.arange(64).reshape(8, 8)
            (x @ x).sum()
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "t")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "user_annotation" and e.get("name") == "read"
               for e in events)
    assert any(e.get("cat") == "cpu_op" for e in events)


def event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_analyse_reads_windows_idle_share_and_gaps():
    """One read span 0-100 us: three launch calls (two hand kernels, one of
    PyTorch's) and a copy; kernels at 10-30, 25-40 (overlapping) and
    70-75; the kernel that ends last runs past the span to 110."""
    names = {"scan_kernel", "fold_round_kernel"}
    trace = {"traceEvents": [
        event("user_annotation", "read", 0, 100),
        event("cuda_runtime", "cudaLaunchKernel", 5, 2, 1),
        event("kernel", "void (anonymous namespace)::scan_kernel<4>(int)",
              10, 20, 1),
        event("cuda_runtime", "cudaLaunchKernel", 8, 1, 2),
        event("kernel", "void at::native::elementwise_kernel<128>()",
              25, 15, 2),
        event("cuda_runtime", "cudaMemcpyAsync", 41, 3, 3),
        event("gpu_memcpy", "Memcpy HtoD", 44, 6, 3),
        event("cuda_runtime", "cudaLaunchKernelExC", 60, 4, 4),
        event("kernel", "(anonymous namespace)::fold_round_kernel(long*)",
              70, 40, 4),
        event("cuda_runtime", "cudaLaunchKernel", 200, 1, 5),   # outside
        event("kernel", "void (anonymous namespace)::scan_kernel<4>(int)",
              201, 5, 5)]}
    (r,) = tool.analyse(trace, names)
    assert r["window_ms"] == 110 / 1e3
    assert r["device_busy_ms"] == (30 + 40) / 1e3            # 10-40, 70-110
    assert abs(r["idle_share"] - (1 - 70 / 110)) < 1e-12
    assert r["copy_ms"] == 6 / 1e3
    assert abs(r["idle_share_with_copies"] - (1 - 76 / 110)) < 1e-12
    assert r["kernels"] == 3 and r["hand_launches"] == 2
    assert r["hand_launch_order"] == ["scan_kernel", "fold_round_kernel"]
    assert r["host_before_first_launch_ms"] == 5 / 1e3
    (gap,) = r["longest_gaps_ms"]
    # from the end of the first launch call (7) to the second hand one (60);
    # the device is busy 10-40 and 44-50 inside it
    assert gap == {"ms": 53 / 1e3, "device_busy_ms": 36 / 1e3,
                   "after": "scan_kernel", "before": "fold_round_kernel"}


def test_hand_kernel_names_are_the_sources_kernels():
    names = tool.hand_kernel_names(os.path.join(ROOT, "sdk_tpu_torch", "csrc"))
    assert {"scan_kernel", "fold_round_kernel", "pack_kernel", "ntt_kernel",
            "expansion_kernel", "regev_to_gsw_kernel"} <= names
    assert tool.hand_name("void at::native::vectorized_elementwise_kernel<4>",
                          names) is None


def test_tool_tiny_cpu_mode_without_jax(tmp_path):
    """--cpu --tiny --target direct: a 4-query direct-upload batch traced on
    the CPU, in a process that refuses jax and sdk_tpu."""
    code = ("import sys, runpy\n"
            "class Refuse:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'sdk_tpu'):\n"
            "            raise ImportError(f'refused: {name}')\n"
            "sys.meta_path.insert(0, Refuse())\n"
            "sys.argv = ['profile_trace_torch.py'] + sys.argv[1:]\n"
            "runpy.run_path('tools/profile_trace_torch.py', "
            "run_name='__main__')\n")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    res = subprocess.run(
        [sys.executable, "-c", code, "--out", str(tmp_path / "trace"),
         "--cpu", "--tiny", "--target", "direct", "--iters", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["target"] == "direct" and line["device"] == "cpu"
    assert line["params"]["direct_upload"] is True
    assert os.path.exists(line["trace_file"])
    (r,) = line["reads"]
    assert r["window_ms"] > 0 and r["hand_launches"] == 0
