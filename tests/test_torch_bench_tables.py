"""PyTorch port, the per-op size sweep and its plot script
(basic_dsp_tpu_torch/examples/bench_tables.py, plot_csv_data.py) against
the JAX examples of the same names, and the port's twin of the device
smokes (basic_dsp_tpu_torch/smoke_checks.py) on the CPU.

Each of the sweep's 30 op bodies goes through JAX's ``build_ops()`` and
the port's on the same seed-0 numpy inputs, at n = 1000 and 4096: within
1e-5 of the maximum, and equal for the four that only move or wrap
values.  The JAX examples are loaded from their files under names of
their own, as tests/test_torch_examples.py does.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basic_dsp_tpu_torch import smoke_checks
from basic_dsp_tpu_torch.examples import bench_tables, plot_csv_data

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = os.path.join(ROOT, "examples")
TPU_CSV = os.path.join(ROOT, "bench_tables_tpu.csv")
H100_CSV = os.path.join(ROOT, "bench_tables_h100.csv")
TOL = 1e-5
EXACT = ("real_wrap", "real_unwrap", "reverse", "swap_halves")
JAX_HEADER = "op,size,msamples_per_s,us_per_call"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_example(name):
    key = f"_jax_{name}"
    spec = importlib.util.spec_from_file_location(
        key, os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_JAX_OPS = {}


def _jax_ops():
    if not _JAX_OPS:
        _JAX_OPS.update(_jax_example("bench_tables").build_ops())
    return _JAX_OPS


def test_the_sweep_has_the_jax_examples_ops():
    assert list(bench_tables.build_ops()) == list(_jax_ops())
    assert len(bench_tables.build_ops()) == 30


def _inputs(n):
    rng = np.random.default_rng(0)
    r = rng.normal(size=n).astype(np.float32)
    i = rng.normal(size=n).astype(np.float32)
    h = (rng.normal(size=32).astype(np.float32),
         rng.normal(size=32).astype(np.float32))
    carry = (rng.normal(size=n) * 1e-3).astype(np.float32)
    win = bench_tables.HammingWindow().sample(n, device="cpu").numpy()
    return r, i, h, win, carry


@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("name", list(bench_tables.build_ops()))
def test_op_body_matches_jax(name, n):
    r, i, h, win, carry = _inputs(n)
    aux = h if name == "convolve_signal" else (win, win)
    want = np.asarray(_jax_ops()[name](
        jnp.asarray(r), jnp.asarray(i), tuple(jnp.asarray(a) for a in aux),
        jnp.asarray(carry)))
    got = bench_tables.build_ops()[name](
        torch.from_numpy(r), torch.from_numpy(i),
        tuple(torch.from_numpy(a) for a in aux),
        torch.from_numpy(carry)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max()
    if name in EXACT:
        assert err == 0, (name, n, err)
    else:
        assert err <= TOL * np.abs(want).max(), (name, n, err)


def test_fold_is_jax_fold():
    """|out| padded to a multiple of n, summed down the short axis."""
    out = torch.arange(10, dtype=torch.float32) - 4.5
    got = bench_tables.fold(out, 4)
    want = np.pad(np.abs(out.numpy()), (0, 2)).reshape(3, 4).sum(0) * 1e-20
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("with_f64", [False, True])
def test_sweep_on_the_cpu_writes_the_csv(tmp_path, with_f64):
    path = tmp_path / "t.csv"
    rows, no_graph = bench_tables.main(3, str(path), with_f64=with_f64,
                                       device="cpu")
    lines = path.read_text().splitlines()
    assert lines[0] == "# cpu"
    assert lines[1].startswith(JAX_HEADER + ",")
    body = [line.split(",") for line in lines[2:]]
    assert len(body) == len(rows) == (33 if with_f64 else 31)
    assert [c[0] for c in body[:31]] == list(bench_tables.build_ops()) \
        + ["vector_creation"]
    for cells in body:
        assert cells[1] == "1000" and float(cells[2]) > 0
        assert float(cells[3]) > 0 and cells[4] == ""  # no device column
    assert all(sec > 0 and dev is None for _, _, sec, dev in rows)
    assert no_graph == {}


def test_sweep_needs_a_card_unless_told(monkeypatch):
    monkeypatch.delenv("BDSP_PLATFORM", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_tables.main(3, os.devnull)


def test_both_plot_scripts_read_the_same_series(tmp_path):
    path = tmp_path / "t.csv"
    bench_tables.main(3, str(path), with_f64=True, device="cpu")
    jax_plot = _jax_example("plot_csv_data")
    for csv in (str(path), TPU_CSV, H100_CSV):
        got = plot_csv_data.read_table(csv)
        assert got == jax_plot.read_table(csv)
        assert len(got) >= 31
    assert len(plot_csv_data.read_table(str(path))["real_offset"]) == 1


def test_the_committed_h100_sweep_is_whole():
    """bench_tables_h100.csv: the card's line, 10^3..10^8 of every op (the
    capped ones to 10^7), the float64 ops, positive eager times."""
    with open(H100_CSV) as f:
        first, header = f.readline().strip(), f.readline().strip()
    assert first.startswith("# NVIDIA H100") and first.endswith(" W")
    assert header == bench_tables.HEADER
    series = plot_csv_data.read_table(H100_CSV)
    ops = list(bench_tables.build_ops()) + ["vector_creation"] \
        + list(bench_tables.F64_OPS)
    assert sorted(series) == sorted(ops)
    for op, pts in series.items():
        top = 7 if op in bench_tables.CAPPED else 8
        assert [n for n, _ in pts] == [10 ** e for e in range(3, top + 1)]
        assert all(rate > 0 for _, rate in pts), op


def test_plot_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib")
    csv = tmp_path / "t.csv"
    csv.write_text("# cpu\n" + JAX_HEADER + ",device_us_per_call\n"
                   "real_offset,1000,27.4,36.55,\n"
                   "real_offset,10000,270.1,37.02,3.10\n")
    png = tmp_path / "out.png"
    assert plot_csv_data.main([str(csv), str(TPU_CSV), "-o", str(png)]) == 0
    assert png.stat().st_size > 0
    assert plot_csv_data.main([]) == 1


def _loop_oracle(x, factor, delay, conv_len, delta=1.0):
    """smoke_accuracy_tpu.py's scalar oracle, as written there."""
    n = len(x)
    delay = delay / delta
    L = min(conv_len, n // 2)
    is_c = np.iscomplexobj(x)
    new_len = int(round(n * (2 if is_c else 1) * factor))
    new_len += new_len % 2
    pts = new_len // 2 if is_c else new_len
    out = np.zeros(pts, dtype=x.dtype if is_c else np.float64)
    for i in range(pts):
        center = i / factor
        r = np.floor(center)
        acc = 0.0
        for t in range(2 * L + 1):
            w = np.sinc(t - L - (center - r) + delay)
            acc += x[int(r - L + t) % n] * w
        out[i] = acc
    return out


@pytest.mark.parametrize("case", smoke_checks.INTERP_CASES[:-1],
                         ids=lambda c: c[0])
def test_vectorized_oracle_is_the_scalar_loop(case):
    _, factor, n, delay, conv_len, cplx = case
    rng = np.random.default_rng(1)
    x = rng.normal(size=n)
    if cplx:
        x = x + 1j * rng.normal(size=n)
    want = _loop_oracle(x, factor, delay, conv_len)
    got = smoke_checks.interp_oracle(x, factor, delay, conv_len)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_smoke_accuracy_checks_pass_on_the_cpu():
    records = smoke_checks.accuracy("cpu")
    assert len(records) == len(smoke_checks.INTERP_CASES) + 9
    for rec in records:
        assert rec["ok"], rec
        assert set(rec["launches"].values()) == {0}


def test_smoke_families_run_on_the_cpu():
    out = smoke_checks.families("cpu")
    assert len(out) == 14
    for name, value in out.items():
        assert np.all(np.isfinite(value)), name
    assert out["interpolatef"].shape == (6144,)
    assert out["interpolatei"].shape == (8192,)
    assert out["interpft"].shape == (8192,)
    assert out["statistics"][0] == 4096
