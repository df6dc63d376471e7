#!/usr/bin/env python3
"""Whether the kernels of ``csrc/rowfft_mag.cu`` that K2 launches, and
K1's output, are the same as in another tree of the repo, and K1's device
time in both, on an NVIDIA GPU.

    python3 basic_dsp_tpu_torch/probes/k2_parity.py OTHER

OTHER is either a directory that holds another commit's files, made with
``git archive <rev> | tar -x -C OTHER`` (a machine without the repo's
history can take it so), or a git revision, which the probe unpacks with
``git archive`` into ``basic_dsp_tpu_torch/_build/parity/``.

1. Builds both trees' ``rowfft_mag.cu`` with the package's nvcc flags and
   ``-Xptxas -v``, into ``basic_dsp_tpu_torch/_build/parity/`` (each tree
   with its own ``csrc`` headers), and compares each instantiation that
   K2 launches: ``stage1_panels`` with the store's twiddle on (a tree from
   before that template argument names it by n1 alone) and the row kernel
   ``rowfft_cluster`` untwiddled (a tree from before the FOLD argument
   names it by L2 alone): the registers, stack frame and spill bytes
   ptxas reports, and the SASS that ``cuobjdump -sass`` prints,
   instruction for instruction with the addresses stripped.  It also
   prints ptxas's counts for the instantiations only one tree may have
   (K8's stage 1, K1's folded twiddle).
2. Runs ``fourstep_mag_fused`` (K2) and ``rowfft_mag`` (K1, with the
   factored twiddle) from each tree's package, each tree in a process of
   its own, at the ten geometries of ``chip_smoke.py``'s phase 1 on the
   same seeded planes, and compares the outputs bit for bit.
3. Times K1 at the chain's (128, 32768) in each tree, one tree at a time
   in turns (other, this, this, other): ``rowfft_mag`` with the twiddle,
   ``natural_flatten`` of it, and ``rowfft_mag_natural`` where the tree
   has it, each the median over CUDA-graph replays of 8 calls that cycle
   through 4 input pairs (128 MiB, beyond the 50 MB L2), in us a call.

Prints one line per check and exits 1 on any difference of steps 1-2.
"""
import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys
import tarfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# chip_smoke.FUSED_GEOMETRIES: two non-power-of-two n1 (the direct sum),
# every power-of-two n1 from 8 to 1024, the 4M geometry and L2 = 1024
GEOMETRIES = [(8, 256), (24, 4096), (128, 32768), (64, 131072), (16, 512),
              (32, 1024), (256, 2048), (512, 256), (1024, 256), (1016, 256)]

# a stage1_panels instantiation's mangled name: n1's log2, then the
# store's twiddle where the tree has that argument
PANELS = re.compile(r"stage1_panelsILi(\d+)E(?:Lb([01])E)?E")
# a rowfft_cluster instantiation's: L2's log2, then FOLD where the tree
# has it
ROWS = re.compile(r"rowfft_clusterILi(\d+)E(?:Lb([01])E)?E")
REGS = re.compile(r"Used (\d+) registers")
STACK = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")


def _other_tree(arg: str, out: Path) -> Path:
    if os.path.isdir(arg):
        return Path(arg).resolve()
    dest = out / re.sub(r"[^A-Za-z0-9_.-]", "_", arg)
    if not dest.is_dir():
        dest.mkdir(parents=True)
        tar = subprocess.run(["git", "-C", str(ROOT), "archive", arg],
                             capture_output=True, check=True).stdout
        tmp = dest.with_suffix(".tar")
        tmp.write_bytes(tar)
        with tarfile.open(tmp) as t:
            t.extractall(dest)
        tmp.unlink()
    return dest


def _key(name: str):
    """("stage1", log2 n1, twiddle) of a ``stage1_panels`` symbol,
    ("rows", log2 L2, fold) of a ``rowfft_cluster`` one (fold False for a
    tree without it: its one row kernel folds nothing), else None."""
    m = PANELS.search(name)
    if m is not None:
        return "stage1", int(m.group(1)), m.group(2) != "0"
    m = ROWS.search(name)
    if m is not None:
        return "rows", int(m.group(1)), m.group(2) == "1"
    return None


def _k2_keys(keys) -> list:
    """The instantiations K2 launches: stage 1 twiddled, rows unfolded."""
    return sorted(k for k in keys
                  if (k[0] == "stage1") == k[2])


def _build(tag: str, tree: Path, out: Path, nvcc: str, flags: list) -> tuple:
    """Compiles ``tree``'s rowfft_mag.cu; returns ({key: (registers,
    stack, spill stores, spill loads)}, {key: [SASS lines]})."""
    csrc = tree / "basic_dsp_tpu_torch" / "csrc"
    lib = out / f"librowfft_mag_{tag}.so"
    proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", f"-I{csrc}", "-o",
                           str(lib), str(csrc / "rowfft_mag.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stderr[-4000:]}")
    ptxas, key = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _key(m.group(1))
            continue
        if key is None:
            continue
        st, rg = STACK.search(line), REGS.search(line)
        if st:
            ptxas.setdefault(key, [None, None, None, None])[1:] = [
                int(v) for v in st.groups()]
        if rg:
            ptxas.setdefault(key, [None, None, None, None])[0] = int(
                rg.group(1))
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    dump = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    sass = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        name, body = func.split("\n", 1)
        key = _key(name)
        if key is not None:
            sass[key] = [re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).strip()
                         for ln in body.splitlines()
                         if re.match(r"\s*/\*[0-9a-f]{4}\*/", ln)]
    return {k: tuple(v) for k, v in ptxas.items()}, sass


def _import(tree: str):
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc
    from basic_dsp_tpu_torch.ops import fourstep

    assert Path(sc.__file__).resolve().is_relative_to(Path(tree)), sc.__file__
    return np, torch, sc, fourstep


def _dump(tree: str, path: str) -> None:
    """K2's and K1's outputs from ``tree``'s package at GEOMETRIES, saved
    to ``path``."""
    np, torch, sc, fourstep = _import(tree)
    outs = {"K2": [], "K1": []}
    for n1, n2 in GEOMETRIES:
        rng = np.random.default_rng(n1 * 7 + n2)
        Ar, Ai = (torch.from_numpy(rng.standard_normal((n1, n2), np.float32))
                  .cuda() for _ in range(2))
        outs["K2"].append(sc.fourstep_mag_fused(Ar, Ai, shift=True).cpu())
        T = tuple(torch.from_numpy(p).cuda()
                  for p in fourstep._dif_twiddle_factored(n1, n2))
        outs["K1"].append(sc.rowfft_mag(Ar, Ai, shift=True, Tfac=T).cpu())
    assert sc.fourstep_mag_fused.launches == len(GEOMETRIES)
    assert sc.rowfft_mag.launches == len(GEOMETRIES)
    torch.save(outs, path)


def _graph_us(torch, fn, inputs, calls=8, reps=15) -> float:
    """Device us a call of ``fn(*inputs[i])``: ``calls`` calls cycling
    through ``inputs`` captured in a CUDA graph, the median of ``reps``
    replays between CUDA events."""
    def loop():
        return [fn(*inputs[c % len(inputs)]) for c in range(calls)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        loop()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        held = loop()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / calls)
    del held, graph
    return statistics.median(times)


def _time(tree: str) -> None:
    """Prints a JSON line of K1's device us at (128, 32768) from
    ``tree``'s package."""
    np, torch, sc, fourstep = _import(tree)
    n1, n2 = 128, 32768
    rng = np.random.default_rng(1)
    inputs = []
    T = tuple(torch.from_numpy(p).cuda()
              for p in fourstep._dif_twiddle_factored(n1, n2))
    W = sc.inner_twiddle(n2 // 128, n2, torch.device("cuda"))
    for _ in range(4):
        inputs.append(tuple(
            torch.from_numpy(rng.standard_normal((n1, n2), np.float32))
            .cuda() for _ in range(2)))
    got = {"K1": _graph_us(torch, lambda a, b: sc.rowfft_mag(a, b, True, T,
                                                             W), inputs),
           "K1 and flatten": _graph_us(torch, lambda a, b: sc.natural_flatten(
               sc.rowfft_mag(a, b, True, T, W)), inputs)}
    if hasattr(sc, "rowfft_mag_natural"):
        got["K1n"] = _graph_us(torch, lambda a, b: sc.rowfft_mag_natural(
            a, b, True, T, W), inputs)
    print(json.dumps(got))


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--dump":
        _dump(argv[2], argv[3])
        return 0
    if len(argv) == 3 and argv[1] == "--time":
        _time(argv[2])
        return 0
    if len(argv) != 2:
        print(__doc__)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    from basic_dsp_tpu_torch.kernels import _build as build

    out = build.BUILD_DIR / "parity"
    out.mkdir(parents=True, exist_ok=True)
    trees = {"other": _other_tree(argv[1], out), "this": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"other tree {trees['other']}", flush=True)
    nvcc = build._nvcc()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        dumps = {tag: pool.submit(subprocess.run, [
            sys.executable, __file__, "--dump", str(tree),
            str(out / f"k2_{tag}.pt")], capture_output=True, text=True)
            for tag, tree in trees.items()}
        builds = {tag: pool.submit(_build, tag, tree, out, nvcc,
                                   build.NVCC_FLAGS)
                  for tag, tree in trees.items()}
        (ptx_o, sass_o), (ptx_t, sass_t) = (builds[t].result()
                                            for t in ("other", "this"))
        for tag, fut in dumps.items():
            proc = fut.result()
            if proc.returncode:
                raise RuntimeError(f"K2 run of {tag} failed:\n"
                                   f"{proc.stderr[-4000:]}")

    same = True
    k2_keys = _k2_keys(ptx_o)
    if not any(k[0] == "stage1" for k in k2_keys) or not any(
            k[0] == "rows" for k in k2_keys):
        print("no stage1_panels or rowfft_cluster instantiation found in "
              "the other tree")
        same = False
    for key in k2_keys:
        a, b = sass_o.get(key), sass_t.get(key)
        eq_ptx = ptx_o[key] == ptx_t.get(key)
        eq_sass = a is not None and a == b
        same &= eq_ptx and eq_sass
        what = (f"stage1_panels<n1={1 << key[1]}, twiddle>" if key[0] ==
                "stage1" else f"rowfft_cluster<L2={1 << key[1]}> untwiddled "
                "(K2's rows)")
        print(f"{what}: ptxas (registers, stack, spill stores, spill loads) "
              f"other {ptx_o[key]}, this {ptx_t.get(key)}, same {eq_ptx}; "
              f"SASS other {None if a is None else len(a)} instructions, "
              f"this {None if b is None else len(b)}, identical {eq_sass}",
              flush=True)
    for tag, ptx, sass in (("other", ptx_o, sass_o), ("this", ptx_t, sass_t)):
        for key in sorted(set(ptx) - set(k2_keys)):
            print(f"{tag}: {key}: ptxas {ptx[key]}, SASS "
                  f"{len(sass.get(key, []))} instructions")

    got_o = torch.load(out / "k2_other.pt")
    got_t = torch.load(out / "k2_this.pt")
    for kernel in ("K2", "K1"):
        bits = [bool(torch.equal(a, b))
                for a, b in zip(got_o[kernel], got_t[kernel])]
        same &= len(bits) == len(GEOMETRIES) and all(bits)
        for (n1, n2), eq in zip(GEOMETRIES, bits):
            print(f"{kernel} at ({n1}, {n2}): bit for bit {eq}")
    print(f"K2 and K1 parity: {'same' if same else 'DIFFERENT'}", flush=True)

    for tag in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, __file__, "--time",
                               str(trees[tag])], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"K1 timing of {tag} failed:\n"
                               f"{proc.stderr[-4000:]}")
        print(f"K1 at (128, 32768), {tag}, device us a call (CUDA-graph "
              f"replay, 4 input pairs): {proc.stdout.strip()} on {smi}",
              flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
