"""The multi-host harness's launcher (counterpart of the repository's
``bench_multihost.py``): ``nhosts`` OS processes, each a host that spawns
``local`` ranks (``multihost_worker``), joined into one process group on a
TCP store at ``localhost``.  The outer axis of the (host, chip) mesh
therefore crosses a real process boundary between hosts.

    python3 -m basic_dsp_tpu_torch.multihost [hosts] [local] [n] [taps]
                                             [--cpu] [--out F]

prints the result as one JSON object (the ``MULTIHOST_RESULT`` line of
rank 0: the five sharded functions against their single-device oracles,
with the kernels each launched, and the sharded FIR timed on the whole
mesh against a host's own mesh), writes it to ``F`` with ``--out`` and
exits 1 when a check failed.  On the card each rank takes one card (over
NCCL), so ``hosts * local`` cards are needed: host h sees cards h * local
to (h + 1) * local - 1 alone (``CUDA_VISIBLE_DEVICES``), as a host of its
own would, and its ranks pick theirs by ``LOCAL_RANK``.  ``--cpu`` runs
gloo ranks on the CPU.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import config

RESULT = "MULTIHOST_RESULT "
_ROOT = Path(__file__).resolve().parent.parent


def run(nhosts: int = 2, local: int = 4, n: int = 1 << 16, taps: int = 31,
        device_type=None, timeout: float = 600.0) -> dict:
    """Starts ``nhosts`` host processes of ``local`` ranks each and returns
    rank 0's result.  A host that fails, or a run past ``timeout``
    seconds, stops every process of the run and raises."""
    kind = config._mesh_device_type(device_type)
    world = nhosts * local
    if kind == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"multihost: {nhosts} x {local} NCCL ranks need "
                           f"{world} cards, {torch.cuda.device_count()} "
                           f"visible")
    port = config.free_port()
    cards = _visible_cards() if kind == "cuda" else None
    with tempfile.TemporaryDirectory(prefix="bdsp_multihost_") as tmp:
        procs, logs = [], []
        try:
            for h in range(nhosts):
                out = open(os.path.join(tmp, f"host{h}.out"), "w+")
                err = open(os.path.join(tmp, f"host{h}.err"), "w+")
                logs.append((out, err))
                env = dict(os.environ)
                if cards is not None:
                    # each host sees its own cards, as a real host does, so
                    # that its ranks' LOCAL_RANK picks among them
                    env["CUDA_VISIBLE_DEVICES"] = ",".join(
                        cards[h * local:(h + 1) * local])
                # a session of its own, so that the host and the ranks it
                # spawns stop together
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "basic_dsp_tpu_torch.multihost_worker", str(h),
                     str(nhosts), str(port), str(local), str(n), str(taps),
                     kind], stdout=out, stderr=err, cwd=_ROOT, env=env,
                    start_new_session=True))
            _wait(procs, logs, timeout)
            for out, _ in logs:
                out.seek(0)
                for line in out:
                    if line.startswith(RESULT):
                        return json.loads(line[len(RESULT):])
            raise RuntimeError("multihost: rank 0 printed no result line")
        finally:
            for p in procs:
                if p.poll() is None:
                    _stop(p)
            for out, err in logs:
                out.close()
                err.close()


def _visible_cards() -> list:
    """The cards this process sees, as ``CUDA_VISIBLE_DEVICES`` names
    them (their indices when it is unset)."""
    listed = os.environ.get("CUDA_VISIBLE_DEVICES")
    if listed is None:
        return [str(i) for i in range(torch.cuda.device_count())]
    return [c.strip() for c in listed.split(",") if c.strip()]


def _stop(p: subprocess.Popen) -> None:
    """Kills a host process and every rank of its session."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    p.wait()


def _wait(procs, logs, timeout: float) -> None:
    """Waits for every host; the first that fails, or the deadline, stops
    them all and raises with the failed host's error output."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = [h for h, p in enumerate(procs)
                  if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                _stop(p)
            h = failed[0] if failed else 0
            err = logs[h][1]
            err.seek(0)
            tail = err.read()[-4000:]
            what = (f"host {h} failed with exit code {procs[h].returncode}"
                    if failed else f"still running after {timeout} s")
            raise RuntimeError(f"multihost: {what}:\n{tail}")
        time.sleep(0.2)
    for h, p in enumerate(procs):
        if p.returncode != 0:
            err = logs[h][1]
            err.seek(0)
            raise RuntimeError(f"multihost: host {h} failed with exit code "
                               f"{p.returncode}:\n{err.read()[-4000:]}")


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    out_path = None
    if "--out" in args:
        i = args.index("--out")
        out_path = args[i + 1]
        del args[i:i + 2]
    cpu = "--cpu" in args
    nums = [int(a) for a in args if a != "--cpu"]
    defaults = [2, 4, 1 << 16, 31]
    nhosts, local, n, taps = nums + defaults[len(nums):]
    result = run(nhosts, local, n, taps, "cpu" if cpu else None)
    text = json.dumps(result)
    print(text)
    if out_path:
        with open(out_path, "w") as f:
            f.write(text + "\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
