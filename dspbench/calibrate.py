"""The readings that a cell's limits are set from (``limits`` in
``workloads/<cell>.json``), at the cell's own size, in one process per
rank:

    python3 -m dspbench.calibrate --workload <cell> --seeds <a,b,...> \
        --control-seeds <x,y,z> [--seconds 1]

- ``program``: for each seed, a run of the cell with a short window at its
  own load (``harness.run_rank``) and the widest of each compared number
  over the outputs it kept, as a benchmark run reads them;
- ``control``: for each control seed, the reference computed in TF32
  (``plain``), one precision below the configuration's, put in the
  program's place on the captures a run compares, and compared with the
  float64 reference as a run compares;
- ``own``: where the entry has a lower-precision path of the program's own
  (``lower_precision`` in ``entries/<config>.py``), the program run with
  it on, for each control seed.

Prints a JSON line for each reading, then the largest program reading and
the smallest control reading of each number.  The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from dspbench import cells, harness, traffic as traffic_mod


def _control(cell, seed: int, device, ranks: int) -> dict:
    """The TF32 reference against the float64 one on the captures of a
    run's sample, each rank's part compared as a run compares it."""
    tr, ref_mod = cell.traffic, cell.reference
    consts = ref_mod.constants(cell.config, int(tr["samples"]), device)
    worst = {}
    for k in traffic_mod.order(tr, seed)[:int(tr["keep"])]:
        xr, xi = traffic_mod.capture(tr, seed, k, device)
        ref = ref_mod.reference(cell.config, consts, xr, xi)
        ctl = ref_mod.reference(cell.config, consts, xr, xi, "tf32")[0]
        for r in range(ranks):
            part = tuple(t.chunk(ranks, dim=-1)[r] for t in ref)
            for name, v in ref_mod.errors(ctl.chunk(ranks, dim=-1)[r],
                                          part).items():
                worst[name] = max(worst.get(name, 0.0), v)
        del ref, ctl, xr, xi
    return worst


def body(cell, device, rank, ranks, stop, seeds, control_seeds, seconds):
    """Every reading of this rank: the program's on each seed, then the
    program's own lower-precision path's and (rank 0) the control's on
    each control seed."""
    out = []
    for seed in seeds:
        res = harness.run_rank(cell, seed, seconds, False, device, rank,
                               ranks, stop=stop)
        out.append(("program", seed, res["checks"], res["calls"]))
    lower = getattr(cell.entry, "lower_precision", None)
    if lower is not None:
        for seed in control_seeds:
            with lower():
                res = harness.run_rank(cell, seed, seconds, False, device,
                                       rank, ranks, stop=stop)
            out.append(("own", seed, res["checks"], res["calls"]))
    if rank == 0:
        for seed in control_seeds:
            out.append(("control", seed, _control(cell, seed, device, ranks),
                        None))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m dspbench.calibrate",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    cell = cells.load(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"calibrate: {cell.name} needs {cell.chips} cards",
              file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = [int(s) for s in args.control_seeds.split(",")]
    results = harness.launch(cell, body, (seeds, control_seeds,
                                          args.seconds), "cuda")
    merged = {}
    for rank_out in results:
        for kind, seed, checks, calls in rank_out:
            m = merged.setdefault((kind, seed), {"calls": calls})
            for name, v in checks.items():
                m[name] = max(m.get(name, 0.0), v)
    summary = {}
    for (kind, seed), m in merged.items():
        print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                          **m}), flush=True)
        for name in cell.limits:
            if name in m:
                agg = max if kind == "program" else min
                key = f"{kind}.{name}"
                summary[key] = agg(summary.get(key, m[name]), m[name])
    print(json.dumps({"cell": cell.name, "summary": summary,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
