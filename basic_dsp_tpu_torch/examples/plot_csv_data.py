"""Plots ``bench_tables.py`` CSV output (twin of
``examples/plot_csv_data.py``, the reference's plot_csv_data.py, which
plots bench_tables.rs tables).

One line per op: size (log) against throughput (Msamples/s, log), from
the first three columns; comment lines (``# <card>, <power limit>``) and
the header are skipped.  Several CSV files overlay (e.g. a run on the
card against one on the CPU); the second and later files plot dashed.
Needs matplotlib.

Usage: python3 -m basic_dsp_tpu_torch.examples.plot_csv_data bench_tables.csv [more.csv ...] [-o out.png]
"""
import sys
from collections import defaultdict


def read_table(path):
    series = defaultdict(list)
    with open(path) as f:
        header = f.readline()
        if not header.startswith("op,"):
            f.seek(0)
        for line in f:
            cells = [c.strip() for c in line.strip().split(",")]
            if len(cells) < 3 or not cells[1].isdigit():
                continue
            series[cells[0]].append((int(cells[1]), float(cells[2])))
    return series


def main(argv):
    out = "bench_tables.png"
    if "-o" in argv:
        i = argv.index("-o")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if not argv:
        print(__doc__)
        return 1
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(11, 7))
    for k, path in enumerate(argv):
        style = "-" if k == 0 else "--"
        label_prefix = "" if len(argv) == 1 else path + " "
        for op, pts in sorted(read_table(path).items()):
            pts.sort()
            ax.plot([p[0] for p in pts], [p[1] for p in pts], style,
                    marker=".", label=label_prefix + op)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("vector size (elements)")
    ax.set_ylabel("throughput (Msamples/s)")
    ax.set_title("basic_dsp_tpu_torch per-op throughput sweep (PyTorch port)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7, ncol=2, loc="upper left")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
