"""The check that decides ``correct``: the references agree with the
program's CPU path, the control (the reference in TF32 in the program's
place) fails the limits, and a run whose timed path is broken underneath
comes out not correct, once for each fault the cells can have."""
import time

import pytest
import torch

from dspbench import cells, harness, run, traffic
from basic_dsp_tpu_torch import pipelines
from basic_dsp_tpu_torch.parallel import channelizer

SEED = 2 ** 31 + 99


def _case(root, name):
    cell = cells.load(name, root)
    n = int(cell.traffic["samples"])
    consts = cell.reference.constants(cell.config, n, "cpu")
    xr, xi = traffic.capture(cell.traffic, SEED, 1, "cpu")
    return cell, consts, xr, xi


@pytest.mark.parametrize("traffic_name", ["tones_tiny", "fm_tiny"])
def test_the_reference_agrees_with_the_programs_cpu_path(tiny_root,
                                                         traffic_name):
    root, names = tiny_root
    cell, consts, xr, xi = _case(root, names[traffic_name])
    entry = cell.entry.Entry(cell.config, consts, cell.traffic, "cpu")
    out = entry(entry.prepare(xr, xi))
    ref = cell.reference.reference(cell.config, consts, xr, xi)
    for name, v in cell.reference.errors(out, ref).items():
        assert v <= cell.limits[name] / 20, (name, v)


@pytest.mark.parametrize("traffic_name", ["tones_tiny", "fm_tiny"])
def test_the_control_fails_the_limits(tiny_root, traffic_name):
    root, names = tiny_root
    cell, consts, xr, xi = _case(root, names[traffic_name])
    ref = cell.reference.reference(cell.config, consts, xr, xi)
    ctl = cell.reference.reference(cell.config, consts, xr, xi, "tf32")[0]
    errs = cell.reference.errors(ctl, ref)
    assert any(v > cell.limits[name] * 3 for name, v in errs.items()), errs


def _stale(forward):
    held = {}

    def f(self, xr, xi):
        if "out" not in held:
            held["out"] = forward(self, xr, xi)
        return held["out"]
    return f


def _half(forward):
    def f(self, xr, xi):
        n = xr.shape[-1]
        xr, xi = xr.clone(), xi.clone()
        xr[n // 2:] = 0
        xi[n // 2:] = 0
        return forward(self, xr, xi)
    return f


def _altered(forward):
    def f(self, xr, xi):
        out = forward(self, xr, xi).contiguous().clone()
        flat = out.view(-1)
        flat[flat.numel() // 3 + 7] += 0.25 * flat.abs().max()
        return out
    return f


def _run(root, name, body=harness.run_body):
    cell = cells.load(name, root)
    res = harness.launch(cell, body, (SEED, 0.3, False,
                                      time.perf_counter()), "cpu")
    return run.assemble(cell, res, False, "cpu", "cpu")


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("traffic_name,module", [
    ("tones_tiny", pipelines.FirFftChainPlanar),
    ("fm_tiny", channelizer.ChannelizeAndDemodPlanar)])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault,
                                            traffic_name, module):
    root, names = tiny_root
    assert _run(root, names[traffic_name])["correct"] is True
    monkeypatch.setattr(module, "forward", fault(module.forward))
    rec = _run(root, names[traffic_name])
    assert rec["correct"] is False and rec["failed"] > 0


def _no_exchange_body(cell, device, rank, ranks, stop, *args):
    """A rank whose halo exchange is left out: zeros where the left
    neighbour's rows belong."""
    from basic_dsp_tpu_torch.parallel import collectives
    collectives.shift_from_left = \
        lambda val, axes, wrap=True: torch.zeros_like(val)
    return harness.run_body(cell, device, rank, ranks, stop, *args)


def test_the_mesh_run_is_correct_and_fails_without_its_exchange(tiny_root):
    root, names = tiny_root
    name = names["fm_tiny_mesh"]
    assert _run(root, name)["correct"] is True
    rec = _run(root, name, _no_exchange_body)
    assert rec["correct"] is False and rec["failed"] > 0
