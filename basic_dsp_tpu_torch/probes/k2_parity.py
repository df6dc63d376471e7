#!/usr/bin/env python3
"""Whether K2's stage 1 (``stage1_panels`` in ``csrc/rowfft_mag.cu``) and
K2's output are the same as in another tree of the repo, on an NVIDIA GPU.

    python3 basic_dsp_tpu_torch/probes/k2_parity.py OTHER

OTHER is either a directory that holds another commit's files, made with
``git archive <rev> | tar -x -C OTHER`` (a machine without the repo's
history can take it so), or a git revision, which the probe unpacks with
``git archive`` into ``basic_dsp_tpu_torch/_build/parity/``.

1. Builds both trees' ``rowfft_mag.cu`` with the package's nvcc flags and
   ``-Xptxas -v``, into ``basic_dsp_tpu_torch/_build/parity/`` (each tree
   with its own ``csrc`` headers), and compares each ``stage1_panels``
   instantiation that K2 launches (the store's twiddle on; a tree from
   before that template argument names it by n1 alone): the registers,
   stack frame and spill bytes ptxas reports, and the SASS that
   ``cuobjdump -sass`` prints, instruction for instruction with the
   addresses stripped.  It also prints ptxas's counts for the
   instantiations without the twiddle (K8's), which only this tree may
   have.
2. Runs ``fourstep_mag_fused`` (K2) from each tree's package, each in a
   process of its own, at the ten geometries of ``chip_smoke.py``'s
   phase 1 on the same seeded planes, and compares the outputs bit for
   bit.

Prints one line per check and exits 1 on any difference.
"""
import concurrent.futures
import os
import re
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
    """(log2 n1, twiddle) of a ``stage1_panels`` symbol, else None."""
    m = PANELS.search(name)
    if m is None:
        return None
    return int(m.group(1)), m.group(2) != "0"


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


def _dump(tree: str, path: str) -> None:
    """K2's outputs from ``tree``'s package at GEOMETRIES, saved to
    ``path``."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    from basic_dsp_tpu_torch.kernels import spectrum_cuda as sc

    assert Path(sc.__file__).resolve().is_relative_to(Path(tree)), sc.__file__
    outs = []
    for n1, n2 in GEOMETRIES:
        rng = np.random.default_rng(n1 * 7 + n2)
        Ar, Ai = (torch.from_numpy(rng.standard_normal((n1, n2), np.float32))
                  .cuda() for _ in range(2))
        outs.append(sc.fourstep_mag_fused(Ar, Ai, shift=True).cpu())
    assert sc.fourstep_mag_fused.launches == len(GEOMETRIES)
    torch.save(outs, path)


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--dump":
        _dump(argv[2], argv[3])
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
    k2_keys = sorted(k for k in ptx_o if k[1])
    if not k2_keys:
        print("no stage1_panels instantiation found in the other tree")
        same = False
    for key in k2_keys:
        n1 = 1 << key[0]
        a, b = sass_o.get(key), sass_t.get(key)
        eq_ptx = ptx_o[key] == ptx_t.get(key)
        eq_sass = a is not None and a == b
        same &= eq_ptx and eq_sass
        print(f"stage1_panels<n1={n1}, twiddle>: ptxas (registers, stack, "
              f"spill stores, spill loads) other {ptx_o[key]}, this "
              f"{ptx_t.get(key)}, same {eq_ptx}; SASS other "
              f"{None if a is None else len(a)} instructions, this "
              f"{None if b is None else len(b)}, identical {eq_sass}",
              flush=True)
    for key in sorted(k for k in ptx_t if not k[1]):
        print(f"stage1_panels<n1={1 << key[0]}, no twiddle> (K8): ptxas "
              f"{ptx_t[key]}, SASS {len(sass_t.get(key, []))} instructions")

    got_o = torch.load(out / "k2_other.pt")
    got_t = torch.load(out / "k2_this.pt")
    bits = [bool(torch.equal(a, b)) for a, b in zip(got_o, got_t)]
    same &= len(bits) == len(GEOMETRIES) and all(bits)
    for (n1, n2), eq in zip(GEOMETRIES, bits):
        print(f"K2 at ({n1}, {n2}): bit for bit {eq}")
    print(f"K2 parity: {'same' if same else 'DIFFERENT'}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
