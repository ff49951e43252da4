"""Output contract of bench.py.

A reader of ``python bench.py`` merges stdout+stderr and parses the LAST
JSON line as the recorded metric, so bench.py prints the headline record
once, in a ``finally``, as the very last line — a trailing aux metric can
never shadow it.  This test runs the real bench in smoke mode
(OGPC_BENCH_SMOKE=1: tiny timing chains, 1 repeat — ~2 min on CPU, with
``JAX_PLATFORMS=cpu`` set explicitly, the one way bench.py runs without a
GPU) and asserts, on the merged stream, that the last JSON line is the
``sintel_sparsematch_throughput`` headline.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_smoke_last_json_line_is_headline():
    env = dict(os.environ)
    env["OGPC_BENCH_SMOKE"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "bench.py"],
        cwd=REPO,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,  # merged, like the driver
        text=True,
        timeout=560,
    )
    assert r.returncode == 0, r.stdout[-4000:]
    json_lines = []
    for line in r.stdout.splitlines():
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            json_lines.append(json.loads(line))
        except ValueError:
            continue
    assert json_lines, "bench printed no JSON lines"
    last = json_lines[-1]
    assert last["metric"] == "sintel_sparsematch_throughput", last
    assert last["unit"] == "Mpix/s"
    assert last["value"] > 0
    assert "vs_baseline" in last
    # printed exactly once, and the run names the device it measured
    heads = [j for j in json_lines
             if j.get("metric") == "sintel_sparsematch_throughput"]
    assert len(heads) == 1
    assert "device: backend=cpu" in r.stdout


def test_bench_refuses_without_gpu():
    """Without a GPU and without an explicit JAX_PLATFORMS=cpu, bench.py
    stops before measuring anything (a CPU number is never a device
    number)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    r = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "found none" in r.stderr
    assert "sintel_sparsematch_throughput" not in r.stdout


def test_bench_env_flag_tolerant_parse():
    """OGPC_BENCH_FAST=true / empty must not crash the parse."""
    sys.path.insert(0, REPO)
    import bench

    for val, want in [("", False), ("0", False), ("false", False),
                      ("no", False), ("1", True), ("true", True),
                      ("yes", True), (" 1 ", True)]:
        os.environ["_OGPC_TEST_FLAG"] = val
        assert bench._env_flag("_OGPC_TEST_FLAG") is want, (val, want)
    del os.environ["_OGPC_TEST_FLAG"]
