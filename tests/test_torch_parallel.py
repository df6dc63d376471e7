"""PyTorch port, the sharded functions (basic_dsp_tpu_torch/parallel/
collectives.py, sharded.py, channelizer.sharded_channelize_and_demod) on
gloo ranks on the CPU, against the JAX package's sharded functions on its
virtual CPU mesh of the same shape (tests/conftest.py).

The ranks of each mesh shape (2, 4 and (2, 2)) are spawned once per
module (``torch_parallel_worker.run``); each returns every case's local
result, and the tests assemble the shards in the mesh's flat order.
Tolerances: 1e-5 relative to the maximum magnitude for float32 and
complex64 results (block and reduction orders differ), |z|-weighted angles
1e-6 for the channelizer, and exact equality for the shifts of a ramp,
the shard placement, indices, counts and error messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import basic_dsp_tpu as bd
from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu.parallel import channelizer as jchan
from basic_dsp_tpu.parallel import collectives as jcol
from basic_dsp_tpu.parallel import sharded as jsh
import basic_dsp_tpu_torch as bt
import torch_parallel_worker as worker

F32 = 1e-5
ANGLE = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[2, 4, (2, 2)],
                ids=lambda s: f"{s}dev" if isinstance(s, int)
                else f"{s[0]}x{s[1]}mesh")
def ranks(request, tmp_path_factory):
    """(shape, jax mesh, inputs, per-rank results): the port's ranks of
    one mesh shape, spawned once for the module."""
    shape = request.param
    results = worker.run(shape, str(tmp_path_factory.mktemp("gloo")))
    jmesh = (bd.make_mesh(shape=shape) if isinstance(shape, tuple)
             else bd.make_mesh(shape))
    return shape, jmesh, worker.inputs(worker.world_of(shape)), results


def _assembled(results, case):
    """The rank-local shards of ``case`` joined in flat (rank) order."""
    return np.concatenate([r[case] for r in results], axis=-1)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def test_flat_index_and_shift_orders(ranks):
    """flat_index is the rank (host-major on the 2-D mesh), flat_size the
    mesh size, and shift_from_left/right of a ramp equal the flattened
    ring shift, JAX's collectives on the same mesh shape (exact)."""
    shape, jmesh, x, results = ranks
    d = worker.world_of(shape)
    assert [r["shifts"]["flat_index"] for r in results] == list(range(d))
    assert all(r["shifts"]["flat_size"] == d for r in results)
    axes = jcol.mesh_axes(jmesh)
    ramp = jax.device_put(jnp.asarray(x["ramp"]),
                          jax.sharding.NamedSharding(jmesh, P(axes)))
    for fn in (jcol.shift_from_left, jcol.shift_from_right):
        for wrap in (True, False):
            want = np.asarray(jax.jit(jax.shard_map(
                lambda v, fn=fn, wrap=wrap: fn(v, axes, wrap=wrap),
                mesh=jmesh, in_specs=P(axes), out_specs=P(axes)))(ramp))
            got = np.concatenate([r["shifts"][f"{fn.__name__}_{wrap}"]
                                  for r in results])
            assert np.array_equal(got, want), (fn.__name__, wrap)
            roll = np.roll(x["ramp"], 8 if fn is jcol.shift_from_left
                           else -8)
            if not wrap:
                if fn is jcol.shift_from_left:
                    roll[:8] = 0
                else:
                    roll[-8:] = 0
            assert np.array_equal(got, roll)


def test_shard_time_axis_is_host_major(ranks):
    """Rank r holds slice r of the signal, and the DTensor's own
    full_tensor() reassembles the signal: DTensor shards the time axis
    over the mesh host-major, as JAX's shard_time_axis places slice r on
    the mesh's flat device r."""
    shape, jmesh, x, results = ranks
    d = worker.world_of(shape)
    ln = worker.N // d
    js = jsh.shard_time_axis(jnp.asarray(x["x_c"]), jmesh)
    where = js.sharding.devices_indices_map(js.shape)
    assert [where[dev][0].start or 0 for dev in jmesh.devices.flat] == [
        r * ln for r in range(d)]
    for r, res in enumerate(results):
        assert np.array_equal(res["shard"]["local"],
                              x["x_c"][r * ln:(r + 1) * ln])
        assert np.array_equal(res["shard"]["full"], x["x_c"])
        assert res["shard"]["placements"] == ["S(0)"] * (
            len(shape) if isinstance(shape, tuple) else 1)


CONV_CASES = [("conv_short_c", "x_c", "h_short_c"),
              ("conv_short_r", "x_r", "h_short_r"),
              ("conv_long_c", "x_c", "h_long_c"),
              ("conv_long_r", "x_r", "h_long_r"),
              ("conv_dtensor", "x_c", "h_long_c")]


@pytest.mark.parametrize("case,sig,taps", CONV_CASES)
def test_sharded_convolve_matches_jax(ranks, case, sig, taps):
    """Short taps (<= 202, the Toeplitz matmuls) and long ones (K3 in
    linear mode), complex and real (a real signal with real taps stays
    float32), from a replicated tensor or a DTensor: JAX's
    sharded_convolve_signal on the same mesh shape (1e-5)."""
    shape, jmesh, x, results = ranks
    want = np.asarray(jsh.sharded_convolve_signal(
        jsh.shard_time_axis(jnp.asarray(x[sig]), jmesh),
        jnp.asarray(x[taps]), jmesh))
    got = _assembled(results, case)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("case,key,factor",
                         [("interp_c_1.5", "interp_c", 1.5),
                          ("interp_r_2.0", "interp_r", 2.0)])
def test_sharded_interpolatef_matches_jax(ranks, case, key, factor):
    """x1.5 complex and x2 real through the halo-extended stencil (K4 on
    the card, its plain version here): JAX's sharded_interpolatef (1e-5)."""
    shape, jmesh, x, results = ranks
    want = np.asarray(jsh.sharded_interpolatef(
        jsh.shard_time_axis(jnp.asarray(x[key]), jmesh),
        jct.SincFunction(), factor, 0.25, 10, jmesh))
    got = _assembled(results, case)
    assert got.shape == (int(x[key].shape[0] * factor),)
    assert _rel(got, want) <= F32


@pytest.mark.parametrize("kind", sorted(worker.ERROR_CASES))
def test_sharded_interpolatef_errors_are_jax(ranks, kind):
    """A length the mesh size does not divide, a shard shorter than the
    window, a shard that 128*Q does not divide: JAX's messages (exact)."""
    shape, jmesh, x, results = ranks
    n_of_d, conv_len = worker.ERROR_CASES[kind]
    n = n_of_d(worker.world_of(shape))
    with pytest.raises(ValueError) as e:
        jsh.sharded_interpolatef(jnp.zeros(n, jnp.complex64),
                                 jct.SincFunction(), 1.5, 0.0, conv_len,
                                 jmesh)
    assert all(r[f"interp_err_{kind}"] == str(e.value) for r in results)


@pytest.mark.parametrize("key", ["x_c", "x_r"])
def test_sharded_sum_matches_jax(ranks, key):
    """The all-reduced sum, the same on every rank: JAX's (1e-5)."""
    shape, jmesh, x, results = ranks
    want = np.asarray(jsh.sharded_sum(
        jsh.shard_time_axis(jnp.asarray(x[key]), jmesh), jmesh))
    for r in results:
        got = r[f"sum_{key[-1]}"]
        assert got.dtype == want.dtype
        assert abs(complex(got) - complex(want)) <= F32 * np.abs(
            x[key]).sum()


@pytest.mark.parametrize("key", ["x_c", "x_r"])
def test_sharded_statistics_matches_jax(ranks, key):
    """Every rank's Statistics equals JAX's: sum, average and rms (the
    complex rms of sum(x*x) for complex data) within 1e-5, min and max
    within 1e-5, their indices and the count exact."""
    shape, jmesh, x, results = ranks
    want = jsh.sharded_statistics(
        jsh.shard_time_axis(jnp.asarray(x[key]), jmesh), jmesh)
    scale = float(np.abs(x[key]).max())
    for r in results:
        got = r[f"stats_{key[-1]}"]
        assert got["count"] == want.count == worker.N
        assert (got["min_index"], got["max_index"]) == (want.min_index,
                                                        want.max_index)
        assert type(got["rms"]) is type(want.rms)
        for f in ("sum", "average", "rms"):
            ref = getattr(want, f)
            assert abs(got[f] - ref) <= F32 * max(abs(ref), 1e-3), f
        for f in ("min", "max"):
            assert abs(got[f] - getattr(want, f)) <= F32 * scale, f


def test_sharded_channelize_matches_jax(ranks):
    """The channelizer with the left neighbour's (t + 1)-row halo: JAX's
    sharded_channelize_and_demod on the same mesh shape, angles weighted
    by |z| (1e-6 of max |z|), z from the float64 filterbank."""
    shape, jmesh, x, results = ranks
    C = worker.CHAN_C
    want = np.asarray(jchan.sharded_channelize_and_demod(
        jsh.shard_time_axis(jnp.asarray(x["chan_x"]), jmesh),
        jnp.asarray(x["chan_proto"]), C, jmesh))
    got = _assembled(results, "chan")
    assert got.shape == want.shape == (C, worker.CHAN_S)
    assert got.dtype == np.float32
    y = bt.polyphase_channelizer(
        torch.from_numpy(x["chan_x"].astype(np.complex128)),
        torch.from_numpy(x["chan_proto"].astype(np.float64)), C).numpy()
    amp = np.abs(y) * np.abs(np.concatenate([y[:, :1] * 0, y[:, :-1]], 1))
    d = np.angle(np.exp(1j * (got.astype(np.float64) - want)))
    assert np.max(amp * np.abs(d)) / np.max(amp) <= ANGLE
