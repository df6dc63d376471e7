"""The port's benchmark programs (twins of the JAX repository's root
programs of the same names): ``bench`` (the flagship chain's throughput,
one JSON line; ``bench_torch.py`` at the root runs it), ``bench_all`` (the
five BASELINE.md configs, with the merge of captures), ``bench_scaling``
(the sharded workloads on 1..N ranks) and ``round_summary`` (the port's
artifacts as one table), on what ``timing`` shares.  Each runs on the card
and exits non-zero without one, unless ``--device cpu`` asks for a
rehearsal on the CPU at a small size."""
