"""PyTorch port, the sharded functions (basic_dsp_tpu_torch/parallel/
collectives.py, sharded.py, sharded_fft.py, mimo.py,
channelizer.sharded_channelize_and_demod), the mesh-sharded vectors
(``to_*_vec_par``) and ``StreamingFir`` over sharded chunks on gloo ranks
on the CPU, against the JAX package's functions on its virtual CPU mesh of
the same shape (tests/conftest.py).

The ranks of each mesh shape (2, 4 and (2, 2)) are spawned once per
module (``torch_parallel_worker.run``); each returns every case's local
result, and the tests assemble the shards in the mesh's flat order.
Tolerances: 1e-5 relative to the maximum magnitude for float32 and
complex64 results (block and reduction orders differ), 1e-10 for
complex128, |z|-weighted angles 1e-6 for the channelizer, and exact
equality for the shifts of a ramp, the shard placement, indices, counts
and error messages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import basic_dsp_tpu as bd
from basic_dsp_tpu import conv_types as jct
from basic_dsp_tpu import streaming as jstreaming
from basic_dsp_tpu.parallel import channelizer as jchan
from basic_dsp_tpu.parallel import collectives as jcol
from basic_dsp_tpu.parallel import mimo as jmimo
from basic_dsp_tpu.parallel import sharded as jsh
from basic_dsp_tpu.parallel import sharded_fft as jsf
import basic_dsp_tpu_torch as bt
from basic_dsp_tpu_torch import vector as tvector
from basic_dsp_tpu_torch.parallel import sharded_fft as tsf
import torch_parallel_worker as worker

F32 = 1e-5
F64 = 1e-10
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


def test_sharded_channelize_spans(ranks):
    """Each rank's call under a profiler is one root span over its steps
    in order, the generic path's rows on the CPU, with no stream ms."""
    _, _, _, results = ranks
    for r in results:
        recs = r["chan_spans"]
        name, call, index, parent, _ = recs[0]
        assert (name, parent) == ("dsp.sharded_channelize", None)
        assert [rec[0] for rec in recs[1:]] == [
            "dsp.taps", "dsp.halo", "dsp.prefix", "dsp.rows", "dsp.wrap"]
        assert all(rec[1] == call and rec[3] == index for rec in recs[1:])
        assert all(rec[4] is None for rec in recs)


def _placed(shape):
    """The placements of a result sharded over every mesh axis on dim 0
    (the time axis of a signal, the rows of a matrix)."""
    return ["S(0)"] * (len(shape) if isinstance(shape, tuple) else 1)


FFT_CASES = [("fft_c128", "fft_c128", True, F64),
             ("fft_c64", "fft_c64", True, F32),
             ("fft_r", "fft_r", True, F32),
             ("fft_c128_rows", "fft_c128", False, F64)]


@pytest.mark.parametrize("case,key,natural,tol", FFT_CASES)
def test_sharded_fft_matches_jax(ranks, case, key, natural, tol):
    """The four-step FFT over three all-to-alls (two without the natural
    order): JAX's sharded_fft on the same mesh shape and numpy's FFT,
    complex128 within 1e-10 of the maximum, complex64 and a real float32
    input (a complex64 spectrum) within 1e-5; natural_order=False gives
    the (n1, n2) matrix sharded over rows, element (k1, k2) bin
    k1 + n1*k2."""
    shape, jmesh, x, results = ranks
    want = np.asarray(jsf.sharded_fft(
        jsh.shard_time_axis(jnp.asarray(x[key]), jmesh), jmesh,
        natural_order=natural))
    got = np.concatenate([r[case]["local"] for r in results],
                         axis=0 if not natural else -1)
    assert all(r[case]["placements"] == _placed(shape) for r in results)
    assert all(r[case]["shape"] == want.shape for r in results)
    assert _rel(got, want) <= tol
    ref = np.fft.fft(x[key].astype(np.complex128))
    if not natural:
        n1, n2 = want.shape
        ref = ref.reshape(n2, n1).T
    assert _rel(got.astype(np.complex128), ref) <= tol


def test_sharded_fft_planar_matches_sharded_fft(ranks):
    """The planar entry (re and im planes in and out, the twiddle as cos
    and sin planes): JAX's sharded_fft_planar and the port's own
    sharded_fft of the same complex64 signal (1e-5)."""
    shape, jmesh, x, results = ranks
    sharding = jax.sharding.NamedSharding(jmesh, P(jcol.mesh_axes(jmesh)))
    jr, ji = (jax.device_put(jnp.asarray(p), sharding)
              for p in (x["fft_c64"].real.copy(), x["fft_c64"].imag.copy()))
    wr, wi = jsf.sharded_fft_planar(jr, ji, jmesh)
    want = np.asarray(wr) + 1j * np.asarray(wi)
    got = _assembled(results, "fft_planar")
    assert _rel(got, want) <= F32
    assert _rel(got, np.concatenate([r["fft_c64"]["local"]
                                     for r in results])) <= F32


def test_sharded_fft_divisibility_error_is_jax(ranks):
    """A length the square of the mesh size does not divide (1023 d):
    JAX's ValueError text (exact)."""
    shape, jmesh, x, results = ranks
    d = worker.world_of(shape)
    with pytest.raises(ValueError) as e:
        jsf.sharded_fft(jnp.zeros(1023 * d, jnp.complex64), jmesh)
    assert all(r["fft_error"] == str(e.value) for r in results)


@pytest.mark.parametrize("n", [4096, 1 << 14, 900])
def test_four_step_matches_jax_and_numpy(n):
    """four_step_fft and four_step_ifft (n * ifft, the rustfft convention)
    on one process, at powers of two and at 900 = 30 * 30: JAX's and
    numpy's within 1e-10 of the maximum (complex128)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    for tfn, jfn, ref in ((tsf.four_step_fft, jsf.four_step_fft,
                           np.fft.fft(x)),
                          (tsf.four_step_ifft, jsf.four_step_ifft,
                           np.fft.ifft(x) * n)):
        got = tfn(torch.from_numpy(x)).numpy()
        assert _rel(got, np.asarray(jfn(jnp.asarray(x)))) <= F64
        assert _rel(got, ref) <= F64


@pytest.mark.parametrize("kind", ["c", "r"])
def test_sharded_convolve_mat_matches_jax(ranks, kind):
    """The channel-parallel MIMO convolution (16 channels of 1024, a (16,
    16, 9) grid; the partial mixes summed by one reduce-scatter): JAX's
    sharded_convolve_mat on the same mesh shape, complex64 and real
    float32 (1e-5), the rows sharded over every mesh axis."""
    shape, jmesh, x, results = ranks
    xs = jax.device_put(jnp.asarray(x[f"mimo_{kind}"]),
                        jax.sharding.NamedSharding(
                            jmesh, P(jcol.mesh_axes(jmesh), None)))
    want = np.asarray(jmimo.sharded_convolve_mat(xs, x[f"mimo_imp_{kind}"],
                                                 jmesh))
    got = np.concatenate([r[f"mimo_{kind}"]["local"] for r in results])
    assert all(r[f"mimo_{kind}"]["placements"] == _placed(shape)
               for r in results)
    assert _rel(got, want) <= F32


def test_sharded_convolve_mat_error_is_jax(ranks):
    """d + 1 channels on a mesh of d: JAX's "mesh size" ValueError
    (exact)."""
    shape, jmesh, x, results = ranks
    d = worker.world_of(shape)
    with pytest.raises(ValueError, match="mesh size") as e:
        jmimo.sharded_convolve_mat(jnp.zeros((d + 1, 256)),
                                   np.zeros((d + 1, d + 1, 5), np.float32),
                                   jmesh)
    assert all(r["mimo_error"] == str(e.value) for r in results)


def _jax_par(x, jmesh, method):
    """The JAX par vector's result of ``method`` (the worker's ``par``
    case)."""
    jv = bd.to_complex_time_vec_par(x["x_c"], jmesh)
    jvr = bd.to_real_time_vec_par(x["x_r"], jmesh)
    if method == "array":
        return jv
    if method == "scale":
        return jv.scale(2.0 - 1.0j)
    if method == "magnitude":
        return jv.magnitude()
    if method == "add":
        return jv.add(bd.to_complex_time_vec_par(x["x_c"][::-1].copy(),
                                                 jmesh))
    if method == "abs_r":
        return jvr.abs()
    if method.startswith("conv_"):
        key = "h_short_c" if method == "conv_63" else "h_long_c"
        return jv.convolve_signal(bd.to_complex_time_vec(x[key]))
    if method == "interp":
        return bd.to_complex_time_vec_par(x["interp_c"], jmesh).interpolatef(
            bd.SincFunction(), 1.5, 0.25, 10)
    if method == "plain_fft_r":
        return jvr.plain_fft()
    return getattr(jv, method)()


# method -> whether the result stays sharded: the sharded counterparts
# (convolve_signal, interpolatef, plain_fft) and the pointwise methods
# keep the placements, a gathering method (reverse) does not.
PAR_METHODS = {"array": True, "scale": True, "magnitude": True, "add": True,
               "abs_r": True, "conv_63": True, "conv_257": True,
               "interp": True, "plain_fft": True, "plain_fft_r": True,
               "reverse": False}


@pytest.mark.parametrize("method", sorted(PAR_METHODS))
def test_par_vector_methods_match_jax(ranks, method):
    """A par vector's method, through its route (sharded counterpart,
    local shards or gathered data): the JAX par vector's result and
    flavor (1e-5), sharded or whole as the route says."""
    shape, jmesh, x, results = ranks
    want = _jax_par(x, jmesh, method)
    got_parts = [r["par"][method] for r in results]
    assert all(p[1] is PAR_METHODS[method] for p in got_parts)
    assert all(p[2] == type(want).__name__ for p in got_parts)
    if PAR_METHODS[method]:
        got = np.concatenate([p[0] for p in got_parts])
    else:
        got = got_parts[0][0]
        assert all(np.array_equal(p[0], got) for p in got_parts)
    assert _rel(got, np.asarray(want.array)) <= F32


def test_par_vector_reductions_match_jax(ranks):
    """points, to_numpy (gathered, exact), sum and statistics (their
    sharded counterparts, the same on every rank): the JAX par vector's
    (1e-5; indices and counts exact)."""
    shape, jmesh, x, results = ranks
    jv = bd.to_complex_time_vec_par(x["x_c"], jmesh)
    jvr = bd.to_real_time_vec_par(x["x_r"], jmesh)
    want = jv.statistics()
    for r in results:
        par = r["par"]
        assert par["points"] == jv.points() == worker.N
        assert np.array_equal(par["to_numpy"], x["x_c"])
        for got, ref in ((par["sum"], jv.sum()), (par["sum_r"], jvr.sum())):
            assert abs(got - ref) <= F32 * abs(ref)
        st = par["statistics"]
        assert (st["count"], st["min_index"], st["max_index"]) == (
            want.count, want.min_index, want.max_index)
        for f in ("sum", "average", "rms", "min", "max"):
            ref = getattr(want, f)
            assert abs(st[f] - ref) <= F32 * max(abs(ref), 1e-3), f


def test_streaming_fir_with_sharded_chunks_matches_jax(ranks):
    """StreamingFir over time-sharded chunks (33 taps, chunks of 1024 and
    one of 16 samples a rank, shorter than m - 1, which is gathered): each
    chunk's output sharded over every mesh axis, the state the chunk's
    last 32 samples on every rank, the outputs JAX's StreamingFir over the
    same chunks and numpy's linear convolution (1e-5)."""
    shape, jmesh, x, results = ranks
    chunks = worker.stream_chunks(worker.world_of(shape))
    fir = jstreaming.StreamingFir(jnp.asarray(x["stream_taps"]))
    st = fir.init_state()
    want, i = [], 0
    for k, c in enumerate(chunks):
        y, st = fir.process(jnp.asarray(x["x_c"][i:i + c]), st)
        want.append(np.asarray(y))
        i += c
        for r in results:
            assert r["stream"]["placements"][k] == _placed(shape)
            assert np.array_equal(r["stream"]["tails"][k],
                                  x["x_c"][i - worker.STREAM_TAPS + 1:i])
    got = np.concatenate([np.concatenate([r["stream"]["outs"][k]
                                          for r in results])
                          for k in range(len(chunks))])
    assert _rel(got, np.concatenate(want)) <= F32
    ref = np.convolve(x["x_c"].astype(np.complex128),
                      x["stream_taps"])[:worker.N]
    assert _rel(got.astype(np.complex128), ref) <= F32


def test_every_vector_method_has_a_par_route():
    """Every public method of DspVector is a metadata accessor or has one
    route for a par vector: its sharded counterpart (a branch of the
    method itself), the local shards or the gathered data (the par
    flavors' own methods); the docstring of each says which, and the
    plain flavors' methods are DspVector's, untouched."""
    meta = {"array", "delta", "domain", "is_complex", "points",
            "is_erroneous", "get_meta_data"}
    routes = [set(tvector._SHARDED_METHODS), set(tvector._LOCAL_METHODS),
              set(tvector._GATHER_METHODS)]
    public = {n for n in dir(bt.DspVector) if not n.startswith("_")}
    assert sum(map(len, routes)) == len(set.union(*routes))
    assert public | {"__getitem__"} == set.union(meta, *routes)
    par = tvector._ParVector
    for name in set.union(*routes):
        owner = bt.DspVector if name in routes[0] else par
        doc = " ".join(getattr(owner, name).__doc__.split())
        assert "On a mesh-sharded vector:" in doc, name
        assert getattr(bt.ComplexTimeVector, name) is getattr(bt.DspVector,
                                                              name)
    assert {plain.__name__ for plain in tvector._PAR_FLAVORS} == {
        "RealTimeVector", "RealFreqVector", "ComplexTimeVector",
        "ComplexFreqVector"}
    assert all(issubclass(p, plain)
               for plain, p in tvector._PAR_FLAVORS.items())
