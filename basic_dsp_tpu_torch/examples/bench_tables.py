"""Size-sweep tables of the per-op cost (twin of
``examples/bench_tables.py``, the reference's bench_tables.rs): 30 ops
and ``vector_creation`` at each size from 10^3 to ``10**max_exp``, as CSV
for ``plot_csv_data.py``.

The ops are the JAX example's, written on the port's functions, each with
its signature ``(x_re, x_im, aux, carry)``.  Each is timed as the JAX
example times it (``bench_all.timed`` there; here ``bench.timing.timed``,
which the port's benchmark programs share): every output element folds
into an n-long float32 carry that the next call adds to its input, and
the time per call is the slope between a loop of ``iters`` calls and one
of ``3 * iters``, the median of three back-to-back pairs.  Two times a
row on the card:

- eager (``us_per_call``): CUDA events at the two ends of the Python
  loop, which is what a caller of the port pays for one call, host
  dispatch included;
- device (``device_us_per_call``): the same loop captured once in a CUDA
  graph and replayed, the twin of JAX's in-jit ``fori_loop``, with no
  host dispatch a call.  An op whose loop cannot be captured (a host
  copy or a host read inside it) has this column empty; the reason is
  printed once, with the op's name.

On the CPU both loops are timed with ``time.perf_counter`` and the device
column is empty.  ``vector_creation`` times ``to_real_time_vec`` of a
numpy array, which on the card copies it there: the clock stops after a
``torch.cuda.synchronize()``, and the row has no device column.

The first line of the CSV names the card and its power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them (``# cpu`` on the CPU); then the JAX example's header and columns,
and the device column.

    python3 -m basic_dsp_tpu_torch.examples.bench_tables [max_exp] [out.csv] [--with-f64]

(the card; ``BDSP_PLATFORM=cpu`` for the CPU).
"""
import os
import sys
import time

import numpy as np
import torch

import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import config
from basic_dsp_tpu_torch import vector as _vec
# fold: the carry the sweep times with, importable from here as before
from basic_dsp_tpu_torch.bench.timing import card_line, fold, timed  # noqa: F401
from basic_dsp_tpu_torch.conv_types import SincFunction
from basic_dsp_tpu_torch.ops import approx_ops, conv_ops, fft_ops, interp_ops
from basic_dsp_tpu_torch.windows import HammingWindow

HEADER = "op,size,msamples_per_s,us_per_call,device_us_per_call"
# ops whose output changes shape or that run a convolution: the sweep stops
# at 10^7 for them, as the JAX example's does
CAPPED = ("convolve_signal", "interpolatei", "interpolatef")
CAP = 10 ** 7
TAPS = 32


def build_ops():
    """op name -> fn(x_re, x_im, aux, carry) -> out, the JAX example's 30
    bodies.  ``carry`` is the fold of the previous call's output, added to
    the input so that each call depends on the one before."""
    sinc = SincFunction()

    def cplx(r, i, c):
        return torch.complex(r + c, i)

    return {
        # --- real elementwise (real_bench.rs:59-346) ---
        "real_offset": lambda r, i, a, c: (r + c) + 5.0,
        "real_scale": lambda r, i, a, c: (r + c) * 2.0,
        "real_abs": lambda r, i, a, c: torch.abs(r + c),
        "real_square": lambda r, i, a, c: (r + c) * (r + c),
        "real_sqrt": lambda r, i, a, c: torch.sqrt(torch.abs(r + c)),
        "real_root": lambda r, i, a, c: torch.abs(r + c) ** (1.0 / 3.0),
        "real_powf": lambda r, i, a, c: torch.abs(r + c) ** 2.5,
        "real_ln": lambda r, i, a, c: torch.log(torch.abs(r + c) + 1.0),
        "real_ln_approx":
            lambda r, i, a, c: approx_ops.ln_approx(torch.abs(r + c) + 1.0),
        "real_exp": lambda r, i, a, c: torch.exp((r + c) * 1e-3),
        "real_exp_approx":
            lambda r, i, a, c: approx_ops.exp_approx((r + c) * 1e-3),
        "real_sin": lambda r, i, a, c: torch.sin(r + c),
        "real_sin_approx": lambda r, i, a, c: approx_ops.sin_approx(r + c),
        # the JAX ``_fmod`` is ``jnp.fmod``, the port's ``wrap`` torch.fmod
        "real_wrap": lambda r, i, a, c: torch.fmod(r + c, 8.0),
        "real_unwrap": lambda r, i, a, c: _vec._unwrap(r + c, 8.0),
        "real_mul": lambda r, i, a, c: (r + c) * i,
        "reverse": lambda r, i, a, c: torch.flip(r + c, dims=(-1,)),
        "swap_halves": lambda r, i, a, c: fft_ops.fft_shift(r + c),
        # --- complex elementwise (complex_bench.rs:17-81) ---
        "complex_offset": lambda r, i, a, c: cplx(r, i, c) + (2 + 1j),
        "complex_scale": lambda r, i, a, c: cplx(r, i, c) * (2 + 0.5j),
        "complex_sin": lambda r, i, a, c: torch.sin(cplx(r, i, c)),
        "complex_conj":
            lambda r, i, a, c: torch.conj_physical(cplx(r, i, c)),
        "complex_magnitude": lambda r, i, a, c: torch.abs(cplx(r, i, c)),
        "complex_mul":
            lambda r, i, a, c: cplx(r, i, c) * torch.complex(i, r),
        # --- convolution / interpolation (complex_bench.rs:83-163) ---
        "convolve_signal":
            lambda r, i, a, c: conv_ops.convolve_signal(
                cplx(r, i, c), torch.complex(a[0], a[1]), True),
        "interpolatei":
            lambda r, i, a, c: interp_ops.interpolatei(
                cplx(r, i, c), sinc, 2, True),
        "interpolatef":
            lambda r, i, a, c: interp_ops.interpolatef(
                cplx(r, i, c), sinc, 1.5, 0.0, 12, 1.0),
        # --- FFT family (time_freq_bench.rs:15-53) ---
        "plain_fft_ifft":
            lambda r, i, a, c: fft_ops.plain_ifft(
                fft_ops.plain_fft(cplx(r, i, c))) / r.shape[-1],
        "window":
            lambda r, i, a, c: cplx(r, i, c) * a[0],
        "fft_ifft":
            lambda r, i, a, c: fft_ops.ifft_shifted(
                fft_ops.fft_shifted(cplx(r, i, c))),
    }


# the 64-bit flavors of offset and sin (real_bench.rs:100-110, 337-346)
F64_OPS = {"real_offset_f64": lambda r, i, a, c: (r + c) + 5.0,
           "real_sin_f64": lambda r, i, a, c: torch.sin(r + c)}


def inputs(n, rng, device):
    """The JAX example's inputs at size n, drawn from ``rng`` in its order:
    float32 planes, 32 complex taps as planes, the Hamming window."""
    def draw(size):
        return torch.from_numpy(rng.normal(size=size).astype(np.float32)
                                ).to(device)
    x_re, x_im = draw(n), draw(n)
    h = (draw(TAPS), draw(TAPS))
    win = HammingWindow().sample(n, device=device)
    return x_re, x_im, h, win


def aux_for(name, h, win):
    return h if name == "convolve_signal" else (win, win)


def _device(device):
    if device is None and os.environ.get("BDSP_PLATFORM") == "cpu":
        return torch.device("cpu")
    return config.resolve_device(device)


def _row(name, n, sec, dev_sec):
    dev_us = "" if dev_sec is None else f"{dev_sec * 1e6:.2f}"
    return f"{name},{n},{n / sec / 1e6:.1f},{sec * 1e6:.2f},{dev_us}"


def main(max_exp=7, out_path="bench_tables.csv", with_f64=False,
         device=None):
    """Writes the sweep to ``out_path`` and returns ``(rows, no_graph)``:
    rows ``(op, size, eager s, device s or None)``, and for each op whose
    loop did not capture, the first reason."""
    dev = _device(device)
    on_card = dev.type == "cuda"
    rng = np.random.default_rng(0)
    ops = build_ops()
    lines = ["# " + card_line(dev), HEADER]
    rows, no_graph = [], {}

    def record(name, n, t):
        rows.append((name, n, t.eager, t.graph))
        lines.append(_row(name, n, t.eager, t.graph))
        print(lines[-1], flush=True)
        if on_card and t.graph is None and name not in no_graph:
            no_graph[name] = t.no_graph
            print(f"{name}: no device time, its loop does not capture "
                  f"into a CUDA graph ({t.no_graph})", flush=True)

    for exp in range(3, max_exp + 1):
        n = 10 ** exp
        x_re, x_im, h, win = inputs(n, rng, dev)
        iters = max(3, min(30, 10 ** 7 // n))
        for name, body in ops.items():
            if name in CAPPED and n > CAP:
                continue
            aux = aux_for(name, h, win)
            record(name, n, timed(body, x_re, x_im, aux, iters=iters))
        # vector_creation (real_bench.rs:59-65): construction from numpy,
        # which on the card includes the copy there
        reps = max(1, 10 ** 6 // n)
        zeros = np.zeros(n, np.float32)
        t0 = time.perf_counter()
        for _ in range(reps):
            bt.to_real_time_vec(zeros, device=dev)
        if on_card:
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        rows.append(("vector_creation", n, dt, None))
        lines.append(_row("vector_creation", n, dt, None))
        print(lines[-1], flush=True)
        if with_f64:
            x64 = torch.from_numpy(rng.normal(size=n)).to(dev)
            for name, body in F64_OPS.items():
                record(name, n, timed(body, x64, x64, (win, win),
                                      iters=iters))
        del x_re, x_im, h, win
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_path}")
    return rows, no_graph


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(int(args[0]) if args else 7,
         args[1] if len(args) > 1 else "bench_tables.csv",
         with_f64="--with-f64" in sys.argv)
