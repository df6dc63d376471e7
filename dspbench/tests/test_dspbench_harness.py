"""The harness: files found by name, BENCHMARK.json's rules, a cell added
as files alone, the result line, the guards (no card, no JAX) and the
traffic generator."""
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, REPO
from dspbench import cells, harness, probes, run, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _benchmark():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def test_every_file_is_found_by_name():
    bench = _benchmark()
    readers = cells.metrics()
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert (cell.config["name"], cell.chips) == (w["config"], w["chips"])
        on_disk = json.loads((BENCH / "workloads" / f"{w['name']}.json")
                             .read_text())
        assert on_disk["traffic"] == w["traffic"]
        for fn in ("Entry", "local", "mesh"):
            assert hasattr(cell.entry, fn)
        for fn in ("constants", "reference", "errors"):
            assert hasattr(cell.reference, fn)
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == \
            c["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert bool(readers[m["name"]].END_TO_END) == \
            (m in bench["end_to_end"])
    # a reader whose cells are left out stays for the PR that adds them
    assert set(readers) >= {m["name"] for m in
                            bench["end_to_end"] + bench["per_layer"]}
    # a cell measured and left out keeps its files for a later PR
    assert set(cells.names(BENCH, "workloads", ".json")) >= \
        {w["name"] for w in bench["workloads"]}


def test_benchmark_json_keeps_the_rules():
    bench = _benchmark()
    assert list(bench) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert bench["paths"] == ["dspbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    used = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        names += [w["name"], w["config"], w["traffic"]]
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(
        1, len(bench["workloads"]) // 4)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"]
                                       for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) >= len(bench["workloads"]) + len(
        bench["configs"])
    assert len(json.dumps(bench)) <= 64 * 1024


def _cpu_run(root, name, seconds=0.3, trace=False):
    cell = cells.load(name, root)
    t0 = time.perf_counter()
    res = harness.launch(cell, harness.run_body, (2 ** 33 + 17, seconds,
                                                  trace, t0), "cpu")
    return cell, res


def test_a_cell_added_as_files_alone_runs(tiny_root):
    root, names = tiny_root
    # a new metric, also as a file alone
    (root / "metrics" / "calls_in_window.py").write_text(
        'UNIT = "calls"\nEND_TO_END = False\n\n\ndef read(t):\n'
        '    return t.calls\n')
    cell, res = _cpu_run(root, names["tones_tiny"], trace=True)
    rec = run.assemble(cell, res, True, "cpu", "cpu")
    assert rec["correct"] is True
    assert rec["metrics"]["calls_in_window"]["value"] == rec["attempted"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_keys(tiny_root, trace):
    root, names = tiny_root
    cell, res = _cpu_run(root, names["fm_tiny"], trace=trace)
    rec = run.assemble(cell, res, trace, "cpu", "cpu")
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(rec)[:5] == keys and list(rec)[-1] == "checks"
    assert set(rec) - set(keys) <= {"breakdown", "checks"}
    assert set(rec["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(rec["device"])
        assert set(rec["metrics"]) == {"host_issue_us"}   # no card: no probe
    else:
        assert set(rec["metrics"]) == {"throughput_msps", "call_p95_ms",
                                       "setup_s"}
    assert rec["correct"] is True and rec["failed"] == 0
    assert rec["attempted"] > 0
    for name, c in rec["checks"].items():
        assert c["value"] <= c["limit"] == cell.limits[name]
    json.dumps(rec)


def test_banned_modules_compare_top_level_names_whole():
    ok = ["basic_dsp_tpu_torch", "basic_dsp_tpu_torch.ops.fourstep",
          "jax_helper", "jaxtyping", "basic_dsp_tpu_torchx", "flaxen",
          "dspbench.run", "basic_dsp_tpu_torch.benchmarks"]
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
           "basic_dsp_tpu", "basic_dsp_tpu.ops", "basic_dsp_tpu_torch.bench",
           "basic_dsp_tpu_torch.bench.timing"]
    assert run.banned_modules(ok) == []
    assert run.banned_modules(ok + bad) == sorted(bad)


def test_what_a_run_imports_loads_no_jax():
    code = (
        "import sys\n"
        "from dspbench import cells, run, harness, calibrate\n"
        "for name in cells.names(cells.ROOT, 'workloads', '.json'):\n"
        "    cells.load(name)\n"
        "cells.metrics()\n"
        "from basic_dsp_tpu_torch.parallel import sharded, collectives\n"
        "print(run.banned_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_references_import_nothing_of_the_program():
    code = (
        "import sys\n"
        "from dspbench import cells\n"
        "for name in cells.names(cells.ROOT, 'references', '.py'):\n"
        "    cells.module(cells.ROOT, 'references', name)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('basic_dsp_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_exits_nonzero_with_no_result(tmp_path):
    cmd = [sys.executable, "-m", "dspbench.run", "--workload",
           "channelizer_fm.capture_4m", "--seed", str(2 ** 31 + 5),
           "--seconds", "1", "--trace", "0"]
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
    # a checkout that holds the benchmark alone
    import shutil
    shutil.copytree(BENCH, tmp_path / "dspbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_captures_depend_on_the_seed_and_the_index_alone():
    tr = {"samples": 4096, "pool": 5, "keep": 2,
          "signal": {"noise_rms": 1.0, "tones": 2,
                     "tone_amplitude": [0.1, 0.2], "fm_grid": 64,
                     "fm_carriers": 3, "fm_amplitude": [0.1, 1.0],
                     "fm_deviation": 0.3, "fm_message": 0.02}}
    seed = 2 ** 31 + 12345
    pool = [traffic.capture(tr, seed, k, "cpu") for k in range(5)]
    again = traffic.capture(tr, seed, 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(pool[3], again))
    other = traffic.capture(tr, seed + 1, 3, "cpu")
    assert not torch.equal(pool[3][0], other[0])
    assert not torch.equal(pool[3][0], pool[2][0])
    assert sorted(traffic.order(tr, seed)) == list(range(5))
    assert traffic.keep_phase(seed) == traffic.keep_phase(seed)


def test_the_keeper_samples_the_whole_window():
    k = traffic.Keeper(4, 5)
    for i in range(1000):
        k.offer(i, i)
    kept = sorted(k.kept)
    assert 2 <= len(kept) <= 4 and kept[-1] >= 500
    assert all(i % k.stride == 5 % k.stride for i in kept)


class _Event:
    def __init__(self, name, start, dur, cuda=False, ann=False, thread=1):
        self._n, self._s, self._d = name, start, dur
        self._c, self._a, self._t = cuda, ann, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return self._a

    def start_thread_id(self):
        return self._t


def test_the_trace_reader_takes_the_union_and_labels_the_gaps():
    ev = [_Event(probes.WINDOW_SPAN, 0, 1000, ann=True),
          _Event(probes.CALL_SPAN, 0, 300, ann=True),
          _Event("aten::mm", 100, 100),
          _Event("k_a", 150, 200, cuda=True),
          _Event("k_b", 250, 200, cuda=True),          # overlaps k_a
          _Event(probes.CALL_SPAN, 100, 800, cuda=True, ann=True),
          _Event(probes.SYNC_SPAN, 300, 700, ann=True),
          _Event("cudaDeviceSynchronize", 440, 160),
          _Event("k_a", 700, 100, cuda=True)]
    r = probes.read_trace(ev)
    assert r["busy_s"] == pytest.approx(400e-9)      # 150..450, 700..800
    assert r["window_s"] == pytest.approx(1000e-9)
    assert r["kernel_s"] == pytest.approx(500e-9)
    assert dict(r["device_ops"]) == pytest.approx({"k_a": 300e-9,
                                                   "k_b": 200e-9})
    gaps = dict(r["idle_gaps"])
    # each gap by the innermost host event at its start
    assert gaps == pytest.approx({probes.CALL_SPAN: 150e-9,   # 0..150
                                  "cudaDeviceSynchronize": 250e-9,
                                  probes.SYNC_SPAN: 200e-9})  # 800..1000


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "dspbench.run", "--workload",
         "channelizer_fm.capture_4m", "--seed", str(2 ** 31 + 77),
         "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["correct"] is True and rec["device"]["platform"] == "gpu"
