"""The harness on the CPU: pieces found by name, the trace and roofline
arithmetic on known inputs, and no result without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, roofline, spec, trace
from portbench.tests import small

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as new
    files (and entries in BENCHMARK.json) run with no edit to a file that
    is there."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    box = json.loads((HERE / "configs" / "cornell_box.json").read_text())
    box.update(name="cornell_small", width=16, height=16, spp_per_step=2)
    (tmp_path / "portbench" / "configs" / "cornell_small.json").write_text(
        json.dumps(box))
    (tmp_path / "portbench" / "traffic" / "cosine_only.json").write_text(
        json.dumps({"why": "cosine bounces alone", "sampling": "cosine",
                    "use_rr": False, "use_nee": False, "use_mis": False,
                    "first_frame_below": 64}))
    frozen = json.loads((HERE / "workloads" /
                         "cornell-parity-1024.json").read_text())
    (tmp_path / "portbench" / "workloads" / "small-cosine.json").write_text(
        json.dumps(dict(frozen, check_pixels=64)))
    (tmp_path / "portbench" / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(len(rec.step_s))\n")
    bench["configs"].append({"name": "cornell_small", "source": "x",
                             "file": "portbench/configs/cornell_small.json",
                             "reduced": ["width"], "why": "x"})
    bench["workloads"].append({"name": "small-cosine",
                               "config": "cornell_small",
                               "traffic": "cosine_only", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["small-cosine"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("small-cosine", tmp_path)
    assert cell.config["width"] == 16 and cell.traffic["sampling"] == "cosine"
    assert [m["name"] for m in cell.end_to_end][-1] == "steps_seen"
    assert "steps_seen" not in [m["name"] for m in
                                spec.cell("cornell-parity-1024",
                                          tmp_path).end_to_end]
    result, _ = harness.run("small-cosine", 11, 60.0, False, device="cpu",
                            max_steps=2, root=tmp_path)
    assert result["correct"]
    assert result["metrics"]["steps_seen"]["value"] == 2.0
    assert set(result["metrics"]) == {"msamples_per_s", "step_ms_p95",
                                      "setup_s", "steps_seen"}


def span(name, ts, dur, cat, **args):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat, "ph": "X",
            "args": args}


def kernel(name, ts, dur):
    return span(name, ts, dur, "kernel", stream=7, correlation=1)


TRACE = [
    span("portbench.step", 0, 100, "user_annotation"),
    span("portbench.issue", 0, 40, "user_annotation"),
    span("portbench.step", 100, 100, "user_annotation"),
    span("portbench.issue", 100, 15, "user_annotation"),
    span("aten::mul", 100, 10, "cpu_op"),
    span("cudaLaunchKernel", 101, 2, "cuda_runtime"),
    # the host waits for the card: left out of the issue's host work
    span("cudaMemcpyAsync", 111, 3, "cuda_runtime"),
    span("cudaDeviceSynchronize", 120, 79, "cuda_runtime"),
    span("portbench.sync", 115, 85, "user_annotation"),
    kernel("k1", 10, 50),
    kernel("k1", 50, 40),
    kernel("acc", 120, 60),
    # left out: an operator's name, no correlation, outside the window
    kernel("aten::mul", 0, 200),
    span("k1", 0, 200, "kernel", stream=7),
    kernel("k1", 300, 50),
]


def test_activity_of_a_recorded_trace():
    act = trace.activity(TRACE)
    assert act.window_s == pytest.approx(200e-6)
    assert act.busy_s == pytest.approx(140e-6)       # 10-90 and 120-180
    assert act.device_s == pytest.approx(150e-6)     # 50 + 40 + 60
    assert act.steps == 2
    assert act.device_ops == [["k1", pytest.approx(90e-6)],
                              ["acc", pytest.approx(60e-6)]]
    labels = [g[0] for g in act.idle_gaps]
    assert labels[0] == "issue: aten::mul"            # 90-120, midpoint 105
    assert act.idle_gaps[0][1] == pytest.approx(30e-6)
    assert [g[1] for g in act.idle_gaps] == pytest.approx(
        [30e-6, 20e-6, 10e-6])
    assert act.host_work_s == pytest.approx([40e-6, 12e-6])


def record(frozen, activity=None, kind="NVIDIA H100 80GB HBM3"):
    cell = spec.Cell("c", {}, {}, {}, frozen, [], [])
    rec = harness.Record(cell=cell, device_kind=kind, samples_per_step=1000,
                         num_tris=10, env_texels=0, pixels=100)
    rec.activity = activity
    rec.step_s = [0.002, 0.004, 0.003]
    rec.window_s = 0.01
    return rec


def test_frozen_floor_and_roofline():
    assert (roofline.TEST_OPS, roofline.SHADE_OPS) == (54, 79)
    frozen = {"rays_per_sample": 2.0, "shadow_rays_per_sample": 1.0}
    assert roofline.step_ops(frozen, 1000) == 1000 * (2 * 133 + 54)
    assert roofline.step_bytes(10, 0, 100) == 10 * 60 + 2 * 100 * 12
    least = 320000 / 67e12
    rec = record(frozen, trace.activity(TRACE))
    assert rec.least_step_s() == pytest.approx(least)
    share = spec.reader("kernels_roofline")(rec)
    assert share == pytest.approx(100 * least / 75e-6)
    assert spec.reader("device_idle_pct")(rec) == pytest.approx(30.0)
    assert spec.reader("msamples_per_s")(rec) == pytest.approx(0.3)
    assert spec.reader("host_issue_ms")(rec) == pytest.approx(0.026)


def test_readers_return_nothing_when_nothing_to_read():
    frozen = {"rays_per_sample": 2.0, "shadow_rays_per_sample": 1.0}
    rec = record(frozen, None, kind="some other card")
    for name in ("kernels_roofline", "device_idle_pct", "host_issue_ms",
                 "bvh_build_s", "kernel_load_s"):
        assert spec.reader(name)(rec) is None


@pytest.mark.parametrize("alone", [False, True])
def test_no_result_without_a_card(tmp_path, alone):
    """run.py exits non-zero and prints no result line on a machine with
    no CUDA device, in the checkout and in a directory that holds only
    BENCHMARK.json and the benchmark's folder."""
    root = ROOT
    if alone:
        shutil.copytree(HERE, tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        root = tmp_path
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         small.CELLS[0], "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
