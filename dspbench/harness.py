"""One run of one cell: set-up, the measured window, the traced readings
and the check, on one card or on every rank of a mesh.

Everything particular to a configuration, a traffic mix or a metric sits
in files found by name under the benchmark's root (``cells.load``), so a
cell, a configuration or a metric is added as new files.

The window is a closed loop with one caller: each call takes the next
capture of the pool (in an order drawn from the seed), calls the entry,
and waits for the result with ``torch.cuda.synchronize()``.  The host
clock marks each call's issue, its return and its completion.  The window
runs until ``seconds`` have passed.  On a mesh a collective pairs each
call of every rank, so every rank makes the same number of calls: when
rank 0 passes the deadline it sets, in memory the ranks share, a last
call a few calls ahead of any rank (``STOP_AHEAD``), and each rank stops
there.

After the window: the memory peak is read; a traced run takes the probes'
device times and one profiled second of the same loop; then the program's
state is freed and the outputs of a sample of the window's calls
(``traffic.Keeper``) are compared with the reference, computed in float64
on the same captures.
"""
from __future__ import annotations

import datetime
import os
import sys
import time

import torch

from . import cells, probes, traffic as traffic_mod

PROFILE_SECONDS = 1.0
NEVER = 1 << 62
# a rank finishes a call only after its left neighbour began it, so no
# rank is more than one call a rank ahead of rank 0
STOP_AHEAD = 2


class Trace:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device):
    if device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def run_rank(cell, seed: int, seconds: float, trace: bool, device,
             rank: int = 0, ranks: int = 1, t0: float = None,
             stop=None) -> dict:
    """Runs the cell on this rank and returns its readings.  Where ranks >
    1 the process group is up and ``stop`` is the shared last call
    (:func:`launch`)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    consts = cell.reference.constants(cfg, int(tr["samples"]), device)
    mesh = cell.entry.mesh(ranks, device) if ranks > 1 else None
    entry = cell.entry.Entry(cfg, consts, tr, device, mesh)
    _sync(device)
    t_entry = time.perf_counter()
    inputs = []
    for k in range(int(tr["pool"])):
        inputs.append(entry.prepare(*traffic_mod.capture(tr, seed, k,
                                                         device)))
    _sync(device)
    t_pool = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    order = traffic_mod.order(tr, seed)
    keep = int(tr["keep"])
    P = len(order)

    def call(i):
        return entry(inputs[order[i % P]])

    # warm-up: every capture of the pool, and as many held outputs as the
    # window's sample will hold, so the allocator has their blocks
    warm = traffic_mod.Keeper(keep, 0)
    for i in range(max(2 * P, 2 * keep + 2, 20)):
        warm.offer(i, call(i))
        _sync(device)
    del warm
    _sync(device)
    if ranks > 1:
        import torch.distributed as dist
        if rank == 0:
            stop.value = NEVER
        dist.barrier()
    setup_s = time.perf_counter() - t0
    if rank == 0:
        print(f"# set-up {setup_s:.3f} s: to the entry {t_entry - t0:.3f}, "
              f"pool {t_pool - t_entry:.3f}, warm-up "
              f"{t0 + setup_s - t_pool:.3f}", file=sys.stderr, flush=True)

    keeper = traffic_mod.Keeper(keep, traffic_mod.keep_phase(seed))
    issue, latency, ends = [], [], []
    i = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        a = time.perf_counter()
        out = call(i)
        b = time.perf_counter()
        _sync(device)
        c = time.perf_counter()
        issue.append(b - a)
        latency.append(c - a)
        ends.append(c)
        keeper.offer(i, out)
        del out
        i += 1
        if ranks == 1:
            if c >= deadline:
                break
            continue
        if rank == 0 and c >= deadline and stop.value == NEVER:
            stop.value = i + STOP_AHEAD * ranks
        if i >= stop.value:
            break
    window_s = c - start
    peak = _peak(device)
    if rank == 0:
        print("# calls in each tenth of the window: " + " ".join(
            str(n) for n in _tenths(start, window_s, ends)),
            file=sys.stderr, flush=True)
    res = {"calls": i, "window_s": window_s, "setup_s": setup_s,
           "memory_peak_bytes": peak, "issue_s": issue,
           "latency_s": latency, "samples": entry.samples}

    if trace:
        # on a mesh every rank makes rank 0's count of profiled calls
        box = [max(1, round(PROFILE_SECONDS * i / window_s))]
        if ranks > 1:
            dist.broadcast_object_list(box, src=0)
        res.update(_traced(entry, inputs, order, device, ranks, box[0]))
    kept = keeper.kept
    del keeper
    entry.close()
    del inputs, entry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res.update(check(cell, seed, kept, device, rank, ranks))
    return res


def _tenths(start, window_s, ends):
    """Calls completed in each tenth of the window (a drift shows)."""
    counts = [0] * 10
    for t in ends:
        counts[min(9, int((t - start) / window_s * 10))] += 1
    return counts


def _traced(entry, inputs, order, device, ranks, profile_calls):
    """The probes' device times and work, and one profiled window."""
    out = {"device_ms": {}, "work": {}, "profile": None}
    if device.type != "cuda":
        return out
    for name, probe in entry.probes(inputs).items():
        out["device_ms"][name] = probes.device_ms(probe, order)
        out["work"][name] = (probe.nbytes, probe.flops)
    _sync(device)
    P = len(order)
    from torch.profiler import record_function

    def loop(deadline, calls):
        i = 0
        while True:
            with record_function(probes.CALL_SPAN):
                res = entry(inputs[order[i % P]])
            with record_function(probes.SYNC_SPAN):
                _sync(device)
            del res
            i += 1
            if (time.perf_counter() >= deadline) if calls is None \
                    else i >= calls:
                return i
    out["profile"] = probes.profiled(
        loop, seconds=PROFILE_SECONDS if ranks == 1 else None,
        calls=profile_calls if ranks > 1 else None)
    return out


def check(cell, seed: int, kept: dict, device, rank: int,
          ranks: int) -> dict:
    """Each kept output against the reference on its capture: the widest
    of each number over the outputs, how many were compared and how many
    passed a limit."""
    tr = cell.traffic
    order = traffic_mod.order(tr, seed)
    by_capture = {}
    for i, out in sorted(kept.items()):
        by_capture.setdefault(order[i % len(order)], []).append(out)
    worst, failed, compared = {}, 0, 0
    consts = cell.reference.constants(cell.config, int(tr["samples"]),
                                      device)
    for k, outs in sorted(by_capture.items()):
        xr, xi = traffic_mod.capture(tr, seed, k, device)
        ref = cell.reference.reference(cell.config, consts, xr, xi)
        del xr, xi
        if ranks > 1:
            ref = tuple(r.chunk(ranks, dim=-1)[rank] for r in ref)
        for out in outs:
            errs = cell.reference.errors(cell.entry.local(out), ref)
            compared += 1
            if any(not (v <= cell.limits[name]) for name, v in errs.items()):
                failed += 1
            for name, v in errs.items():
                worst[name] = max(worst.get(name, 0.0), v)
        del ref, outs
    return {"checks": worst, "compared": compared, "failed": failed}


def _rank_main(name, root, body, args, device_type, rank, ranks, port,
               stop):
    """A spawned rank of a mesh run: joins the process group, runs
    ``body``, hands its result to rank 0, leaves the group; exits non-zero
    on any failure."""
    try:
        _mesh_rank(cells.load(name, root), body, args, device_type, rank,
                   ranks, port, stop)
    except BaseException:
        import traceback
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _mesh_rank(cell, body, args, device_type, rank, ranks, port, stop):
    import torch.distributed as dist
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)   # ranks share the host's cores
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", world_size=ranks, rank=rank,
        timeout=datetime.timedelta(seconds=120))
    try:
        res = body(cell, device, rank, ranks, stop, *args)
        gathered = [None] * ranks
        dist.all_gather_object(gathered, res)
    finally:
        dist.destroy_process_group()
    return gathered


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch(cell, body, args: tuple, device_type: str) -> list:
    """``body(cell, device, rank, ranks, stop, *args)`` on ``cell.chips``
    ranks, this process rank 0 and the others spawned (a process group
    joins them; ``stop`` is an integer in memory they share, None on one
    card), and every rank's result, rank 0's first.  Waits for every
    process it started; a rank that fails ends the run."""
    if cell.chips == 1:
        dev = torch.device("cuda" if device_type == "cuda" else "cpu")
        return [body(cell, dev, 0, 1, None, *args)]
    import multiprocessing
    import threading
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    stop = ctx.Value("q", NEVER, lock=False)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(cell.name, cell.root, body, args,
                               device_type, r, cell.chips, port, stop))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            for p in procs:
                if p.exitcode not in (None, 0):
                    print(f"dspbench: rank {procs.index(p) + 1} failed "
                          f"(exit {p.exitcode})", file=sys.stderr,
                          flush=True)
                    for q in procs:
                        q.kill()
                    os._exit(1)
    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    try:
        results = _mesh_rank(cell, body, args, device_type, 0, cell.chips,
                             port, stop)
        done.set()
        watcher.join()
        for p in procs:
            p.join(timeout=60)
    finally:
        done.set()
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return results


def run_body(cell, device, rank, ranks, stop, seed, seconds, trace, t0):
    """The body of one benchmark run (:func:`launch`): rank 0 keeps its
    per-call times, the others hand back none."""
    res = run_rank(cell, seed, seconds, trace, device, rank, ranks, t0,
                   stop)
    if rank != 0:
        res["issue_s"] = res["latency_s"] = None
    return res
