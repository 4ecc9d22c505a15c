"""The benchmark's harness on the CPU: its data resolves by name, the
generator hits the paper's Table 2 rows, the traced window reduces as the
readers expect, the result line has the contract's keys, and the command
refuses to run without a card or with JAX loaded."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chipbench import bench  # noqa: E402
from chipbench.gen import workload  # noqa: E402
from chipbench.trace import TraceSummary  # noqa: E402

ROOT = bench.ROOT
SPEC = bench.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = bench.cell(name)
    assert bench.loop(cell.traffic["kind"]).run
    assert cell.end_to_end and cell.per_layer and cell.limits
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(bench.reader(m["name"]))
    cfg = next(c for c in SPEC["configs"] if c["name"] == cell.config["name"])
    assert cfg["source"] == cell.config["source"]
    assert cfg["reduced"] == cell.config["reduced"]


@pytest.mark.parametrize("name,vol80_max,kurt", [
    ("iiot-800k", 4.0, (1.7, 3.0)), ("fraud-7k", 8.0, (6.0, 16.0))])
def test_generator_hits_table2(name, vol80_max, kurt):
    cfg = bench.load_json(os.path.join(ROOT, "chipbench", "configs",
                                       name + ".json"))["stream"]
    spec = workload.spec_from_config(cfg)
    a = spec.zipf_exponent
    assert abs(workload.vol80_fraction(workload.zipf_weights(
        spec.n_keys, a)) - cfg["vol80_target"]) < 1e-3
    assert workload.calibrate_zipf(spec.n_keys, cfg["vol80_target"]) == a
    s = workload.generate(spec, 2 ** 33 + 5, 2)
    st = s.stats(spec.n_keys)
    anom = 100 * spec.anomaly_rate
    assert abs(st["anomaly_pct"] - anom) < 0.2 * anom + 0.1
    assert st["vol80_pct"] <= vol80_max
    assert kurt[0] <= st["kurtosis"] <= kurt[1]
    assert np.all(np.diff(s.t) >= 0)
    # the second span continues the first at the same per-key rates
    n = spec.span_events
    c1 = np.bincount(s.key[:n], minlength=spec.n_keys)
    c2 = np.bincount(s.key[n:], minlength=spec.n_keys)
    top = np.argsort(-c1)[:20]
    assert np.allclose(c2[top], c1[top], rtol=0.25)
    assert np.array_equal(workload.generate(spec, 2 ** 33 + 5, 2).key, s.key)


def test_repeating_stream_continues_in_time():
    spec = workload.StreamSpec(n_keys=50, span_events=100, anomaly_rate=0.1,
                               zipf_exponent=1.1, mark="uniform",
                               mark_param=0.0)
    rep = workload.Repeating(workload.generate(spec, 4, 1))
    key, q, t = rep.events(50, 260)
    assert key.size == 210 and np.all(np.diff(t) > 0)
    assert np.array_equal(key[50:150], rep.base.key)
    pos = np.flatnonzero(rep.base.key == rep.base.key[0])
    got = np.concatenate([pos[a:b] + k * rep.n
                          for k, a, b in rep.positions(pos, 0, 300)])
    assert np.array_equal(rep.at(got)[0], np.full(got.size, key[50]))
    assert np.array_equal(rep.at(np.arange(50, 260))[2], t)


def test_a_metric_must_move_an_end_to_end_metric_of_its_cells(tmp_path):
    """A per-layer metric whose ``moves`` is no end-to-end metric of a cell
    it applies to is an error, not a metric silently left out."""
    import shutil

    spec = json.loads(json.dumps(SPEC))
    spec["per_layer"][0]["moves"] = "no_such_metric"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(os.path.join(ROOT, "chipbench", "configs"),
                    tmp_path / "chipbench" / "configs")
    name = (spec["per_layer"][0].get("workloads") or CELLS)[0]
    with pytest.raises(ValueError, match="no_such_metric"):
        bench.cell(name, root=str(tmp_path))
    for cell in CELLS:
        moved = {m["moves"] for m in bench.cell(cell).per_layer}
        assert moved <= {m["name"] for m in bench.cell(cell).end_to_end}


class _Event:
    def __init__(self, name, cuda, a, b, cid=0, link=0, tid=1):
        self.v = (name, torch.autograd.DeviceType.CUDA if cuda
                  else torch.autograd.DeviceType.CPU, a, b, cid, link, tid)

    def name(self):
        return self.v[0]

    def device_type(self):
        return self.v[1]

    def start_ns(self):
        return self.v[2]

    def duration_ns(self):
        return self.v[3] - self.v[2]

    def correlation_id(self):
        return self.v[4]

    def linked_correlation_id(self):
        return self.v[5]

    def start_thread_id(self):
        return self.v[6]


def test_trace_summary_and_readers():
    ev = [_Event("chipbench.process_stream", False, 0, 100, cid=1),
          _Event("aten::add", False, 10, 20, cid=2),
          _Event("cudaLaunchKernel", False, 12, 15, cid=900, link=2),
          _Event("chipbench.process_stream", True, 15, 60),
          _Event("add_kernel", True, 30, 40, link=2),
          _Event("thinning_rmw_kernel<true>", True, 60, 70, link=2),
          _Event("chipbench.score", False, 100, 200, cid=3),
          _Event("aten::mm", False, 110, 150, cid=4),
          _Event("gemm", True, 150, 170, link=4),
          _Event("sink thread op", False, 0, 300, cid=5, tid=2)]
    s = TraceSummary(ev, 0, 200)
    assert s.busy_s == pytest.approx(40e-9)
    assert s.window_s == pytest.approx(200e-9)
    assert s.span_device_seconds("process_stream") == pytest.approx(20e-9)
    assert s.span_device_seconds("score") == pytest.approx(20e-9)
    idle = dict(s.idle_by_host)
    assert idle["aten::mm"] == pytest.approx(80e-9)
    assert idle["cudaLaunchKernel"] == pytest.approx(30e-9)
    assert "sink thread op" not in idle
    view = type("V", (), {"trace": s, "counters": {
        "traced_blocks": 2, "traced_s": 1.0, "window_s": 1.0,
        "sink_submit_wait_s": 0.25,
        "frontend_events": 300, "frontend_dispatches": 3,
        "dispatch_ms": [1.0, 2.0, 5.0]}})()
    assert bench.reader("step_device_ms.stream")(view) == pytest.approx(1e-5)
    assert bench.reader("sink_wait_pct.stream")(view) == pytest.approx(25)
    assert bench.reader("mean_batch.online")(view) == 100
    assert bench.reader("dispatch_ms.online")(view) == 2.0
    empty = type("V", (), {"trace": None, "counters": {}})()
    for m in SPEC["per_layer"]:
        assert bench.reader(m["name"])(empty) is None


def test_result_line_has_the_contracts_keys():
    from chipbench import run as bench_run
    from chipbench.test_chipbench_check import small_cell

    for name in CELLS:
        cell = small_cell(name)
        line, _ = bench_run.run_cell(cell, 11, 0.3, False,
                                     torch.device("cpu"),
                                     t_start=time.perf_counter())
        assert list(line) == ["correct", "attempted", "failed", "metrics",
                              "device", "checks"]
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert set(line["device"]) == {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for v in line["checks"].values():
            assert set(v) == {"value", "limit"}
        json.dumps(line, allow_nan=False)


def _run_py(tmp_path, *args, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chipbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_run_refuses_without_a_card(tmp_path):
    out = _run_py(tmp_path, "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "chipbench"), tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path, "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0", cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


GUARD = """
import importlib.util, os, sys
sys.path[:0] = [{root!r}, os.path.join({root!r}, "src")]
import chipbench.run, chipbench.check, chipbench.control, chipbench.sweep
import chipbench.traffic.stream, chipbench.traffic.online
import chipbench.reference.engine
from chipbench import bench
spec = bench.load_json(os.path.join({root!r}, "BENCHMARK.json"))
for m in spec["per_layer"]:
    bench.reader(m["name"])
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_import_guard():
    """Nothing the benchmark loads imports JAX or the JAX package, and the
    reference loads nothing of the port, by whole top-level names."""
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    names = set(out.stdout.strip().split(","))
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    ref_only = ("import sys; sys.path[:0] = [{root!r}]\n"
                "import chipbench.reference.engine, chipbench.check\n"
                "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    out = subprocess.run([sys.executable, "-c", ref_only.format(root=ROOT)],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert "'repro_torch'" not in out.stdout and "'repro'" not in out.stdout


def test_forbidden_modules_compare_whole_names():
    from chipbench import run as bench_run

    assert bench_run.loaded_forbidden(
        ["repro_torch", "repro_torch.core", "jaxtyping", "numpy"]) == []
    assert bench_run.loaded_forbidden(
        ["repro.core", "jax._src.api", "flax", "jaxlib"]) == \
        ["flax", "jax", "jaxlib", "repro"]
