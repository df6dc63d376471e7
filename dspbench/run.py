"""Runs one cell of the benchmark once and prints its result as the last
line of standard output:

    python3 -m dspbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``basic_dsp_tpu_torch``.  With
``--trace 0`` the line's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read after a window measured the same
way, with the device's busy time from one profiled second and, where the
profiler's kernel total agrees with the call's graph replay, a breakdown.
The numbers the check compared come last, beside their limits, in the
line (``checks``) and as the last lines of standard error.

Exits non-zero and prints no result without CUDA or with fewer cards than
the cell asks for (never falling back to the CPU), and when a module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``basic_dsp_tpu``
(or any of ``basic_dsp_tpu_torch.bench``) is loaded once the window has
closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from dspbench import cells, harness  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "basic_dsp_tpu")
BANNED_PACKAGE = "basic_dsp_tpu_torch.bench"
AGREEMENT = 0.1   # the profiler's kernel total within 10 % of the replay


def banned_modules(modules) -> list:
    """The names in ``modules`` whose top-level name, compared whole, is
    one of ``BANNED``, or that are ``BANNED_PACKAGE`` or inside it."""
    return sorted(m for m in modules
                  if m.split(".")[0] in BANNED or m == BANNED_PACKAGE
                  or m.startswith(BANNED_PACKAGE + "."))


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def assemble(cell, results: list, trace: bool, platform: str,
             kind: str) -> dict:
    """The result line from every rank's readings (rank 0 first)."""
    r0 = results[0]
    t = harness.Trace(calls=r0["calls"], window_s=r0["window_s"],
                      setup_s=r0["setup_s"], issue_s=r0["issue_s"],
                      latency_s=r0["latency_s"], samples=r0["samples"],
                      chips=cell.chips, device_ms=r0.get("device_ms", {}),
                      work=r0.get("work", {}))
    metrics = {}
    for name, mod in cells.metrics(cell.root).items():
        if bool(mod.END_TO_END) == trace:
            continue
        value = mod.read(t)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    peaks = [r["memory_peak_bytes"] for r in results]
    device = {"platform": platform, "kind": kind, "count": cell.chips,
              "memory_peak_bytes": None if None in peaks else max(peaks)}
    rec = {"correct": None, "attempted": r0["calls"],
           "failed": sum(r["failed"] for r in results),
           "metrics": metrics, "device": device}
    profiles = [r["profile"] for r in results if r.get("profile")]
    if trace:
        busy = [p["busy_s"] for p in profiles if p["busy_s"] is not None]
        device["busy_s"] = statistics.mean(busy) if busy else None
        device["window_s"] = profiles[0]["window_s"] if profiles else None
        p0, call = r0.get("profile"), t.device_ms.get("call")
        if p0 and call and p0["kernel_s"] is not None:
            ratio = p0["kernel_s"] / p0["calls"] * 1e3 / call
            print(f"# profiler: kernels {p0['kernel_s']:.6f} s over "
                  f"{p0['calls']} calls, {ratio:.4f} of the graph replay's "
                  f"{call:.6f} ms a call", file=sys.stderr)
            if abs(ratio - 1.0) <= AGREEMENT:
                rec["breakdown"] = {"device_ops": p0["device_ops"],
                                    "idle_gaps": p0["idle_gaps"]}
    checks = {}
    for r in results:
        for name, v in r["checks"].items():
            checks[name] = max(checks.get(name, 0.0), v)
    compared = sum(r["compared"] for r in results)
    rec["correct"] = bool(compared > 0 and rec["failed"] == 0 and all(
        checks.get(name, float("inf")) <= limit
        for name, limit in cell.limits.items()))
    print(f"# compared {compared} outputs, {rec['failed']} over a limit",
          file=sys.stderr)
    rec["checks"] = {name: {"value": checks.get(name), "limit": limit}
                     for name, limit in cell.limits.items()}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m dspbench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("dspbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"dspbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    results = harness.launch(cell, harness.run_body,
                             (args.seed, args.seconds, bool(args.trace), T0),
                             "cuda")
    print(f"# card: {_card()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    found = banned_modules(list(sys.modules))
    if found:
        print(f"dspbench: modules the benchmark must not load are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    rec = assemble(cell, results, bool(args.trace), "gpu",
                   torch.cuda.get_device_name(0))
    print(json.dumps(rec), flush=True)
    for name, c in rec["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
