"""The port's benchmark artifacts as one table (twin of the JAX
repository's ``round_summary.py``): ``BENCH_ALL_h100.json`` (written by
``bench_all --json`` or ``--merge``) and ``SCALING_h100.json`` (``bench_scaling
--out``), each where it exists in the directory; the others are skipped.

    python3 -m basic_dsp_tpu_torch.bench.round_summary [DIR]

(DIR the repository's root by default).  It reads files only, so it runs
anywhere.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_ALL = "BENCH_ALL_h100.json"
SCALING = "SCALING_h100.json"


def _load(root: str, name: str):
    path = os.path.join(root, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _num(v, fmt: str) -> str:
    """``v`` in ``fmt``, or "-" in its width for None."""
    if v is None:
        return "-".rjust(int(fmt.split(".")[0] or 0))
    return format(v, fmt)


def lines(root: str = ROOT) -> list:
    """The table's lines for the artifacts under ``root``."""
    out = []
    ba = _load(root, BENCH_ALL)
    if ba:
        probes = ([ba["probe_us"]] if "probe_us" in ba else sorted(
            {cap["probe_us"] for c in ba["configs"]
             for cap in c.get("captures", [])}))
        out.append(f"{BENCH_ALL}: {ba.get('card', ba.get('device'))}, "
                   f"health probe {probes} us")
        out.append("config                           measured_ms  floor_ms  "
                   "vs_floor  timing  idle   launches  captures")
        for c in ba["configs"]:
            out.append(
                f"{c['metric']:32s} {_num(c.get('measured_ms'), '11.4f')}  "
                f"{_num(c.get('floor_ms'), '8.4f')}  "
                f"{_num(c.get('vs_baseline'), '8.4f')}  "
                f"{c.get('timing', '-'):6s}  "
                f"{_num(c.get('idle_share'), '5.3f')}  "
                f"{json.dumps(c.get('launches', {})):9s} "
                f"{c.get('n_captures', 1):3d}"
                + ("  UNHEALTHY" if c.get("unhealthy") else ""))
    sc = _load(root, SCALING)
    if sc:
        out.append(f"{SCALING}: {sc.get('card')}, {sc.get('mode')}")
        for name, e in sc["workloads"].items():
            ms = [round(p["ms"], 4) for p in e["strong"]]
            proj = [round(p["projected_efficiency"], 4)
                    for p in e.get("link_projection", [])]
            out.append(f"scaling {name:22s} ranks "
                       f"{[p['devices'] for p in e['strong']]} ms {ms} "
                       f"eff {e['strong_efficiency']} link-proj {proj}")
    return out


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    out = lines(argv[0] if argv else ROOT)
    for line in out:
        print(line)
    return out


if __name__ == "__main__":
    main()
