"""Streaming (chunked) processing (counterpart of
``basic_dsp_tpu/streaming.py``).

Serving pipelines process an unbounded signal in chunks.  These helpers
carry the small overlap state between chunks explicitly (a function of
(chunk, state)), so a chunked run reproduces the whole-buffer *linear*
convolution (the reference's whole-buffer equivalence contract,
convolution.rs:304-462) and the whole-buffer linear resample.

On the card a float32 or complex64 chunk runs a kernel: the FIR through
K3 in linear mode (``overlap_save_cuda.conv_blocks_cuda(linear=True)``,
the taps' spectrum held), the resampler through K4 or K5 (the routing of
``interp_ops._interpolatef_direct``).  A CPU chunk runs their plain
versions; the FIR's whole-extent regime and float64 chunks run on
``torch.fft`` in the promoted dtype, as the JAX package does.  A FIR may
hold a bank of taps, (P, m), filtering the one stream with each row: one
K3 launch a chunk for the whole bank.

Spans (``profiling``; no-ops unless a profiler is active): each
``StreamingFir.process`` is a root ``dsp.stream`` over ``dsp.extend``
(the tail and chunk joined, the new tail), the FIR (``dsp.K3`` where the
kernel runs) and ``dsp.assemble`` (the valid outputs sliced out and
assembled).  ``StreamingFir.chunks`` and ``StreamingFir.rows`` count the
chunks and the rows (chunks x P) processed, outside CUDA-graph captures.
Each ``StreamingResampler.process`` is a root ``dsp.resample_stream`` over
``dsp.rotate`` (what the join leaves: the new tail's allocation where the
kernel reads tail and chunk in place, else the rotated extension and the
new tail; the tail's cast where the state keeps another dtype) and the
resampler (``dsp.K4`` or ``dsp.K5``); ``StreamingResampler.chunks``,
``StreamingResampler.rows`` and ``StreamingResampler.in_place`` count its
chunks, their channels and the chunks (float32 or complex64) whose tail
and chunk went to the kernel apart, ``StreamingResampler.planned_chunks``
those its held launch plan issued.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import config, profiling
from .kernels import _build, resample_cuda
from .ops import conv_ops, interp_ops


class FirState(NamedTuple):
    """Carry for streaming FIR: the last ``m - 1`` input samples."""

    tail: torch.Tensor


def _as_taps(taps, device) -> torch.Tensor:
    """A tensor keeps its device; numpy or list data goes to ``device``
    (the card when None)."""
    if isinstance(taps, torch.Tensor):
        return taps.detach()
    return torch.as_tensor(np.asarray(taps),
                           device=config.resolve_device(device))


class StreamingFir:
    """Causal-aligned streaming FIR with the centered-kernel taps.

    For chunk sequence x_0, x_1, ... the concatenated outputs equal the
    *linear* convolution of the concatenated input, causal part: the
    centered convolution delayed by ``c - 1`` samples (the lookahead of
    the centered kernel becomes latency, as in any real-time filter).

    ``taps``: a tensor (it keeps its device) or numpy data (put on
    ``device``, the card when None), of shape (m,), or (P, m) for a bank:
    the one stream filtered with each row, each chunk giving (P, len)
    outputs from one K3 launch, the state still the stream's one tail.
    ``fft_len`` is the JAX package's block length; the kernel runs the
    same linear convolution at that length clamped into its [1024, 16384]
    range.
    """

    chunks = 0
    rows = 0

    def __init__(self, taps, device=None):
        self.taps = _as_taps(taps, device)
        if self.taps.dim() not in (1, 2) or 0 in self.taps.shape:
            raise ValueError(f"StreamingFir: taps of shape (m,) or (P, m), "
                             f"got {tuple(self.taps.shape)}")
        self.m = int(self.taps.shape[-1])
        self.bank = self.taps.dim() == 2
        self.fft_len = conv_ops.pick_fft_len(self.m)
        self._held = {}

    def init_state(self, dtype=torch.complex64, device=None) -> FirState:
        """Zero tail of ``m - 1`` samples in the promoted type of ``dtype``
        and the taps, on ``device`` (the taps' when None)."""
        dt = torch.promote_types(dtype, self.taps.dtype)
        dev = self.taps.device if device is None else device
        return FirState(tail=torch.zeros((max(self.m - 1, 0),), dtype=dt,
                                         device=dev))

    def _held_taps(self, ext: torch.Tensor, fl_k: int):
        """(h, H): the taps in ``ext``'s dtype on its device (the real part
        for a real chunk, as the JAX step casts them), and with ``fl_k``
        their kernel spectrum (``overlap_save_cuda.spectrum``, a row for
        each row of a bank), both built at the first chunk of that device,
        dtype and block length, then held."""
        key = (ext.device, ext.dtype, fl_k)
        held = self._held.get(key)
        if held is None:
            h = self.taps.to(ext.device)
            if h.is_complex() and not ext.is_complex():
                h = h.real
            h = h.to(ext.dtype)
            H = None
            if fl_k:
                from .kernels import overlap_save_cuda
                H = overlap_save_cuda.spectrum(h, fl_k)
            held = self._held[key] = (h, H)
        return held

    def _fir(self, ext: torch.Tensor, n_out: int,
             like: torch.Tensor) -> torch.Tensor:
        """out[i] = sum_k h[k] ext[i + m - 1 - k], i < n_out: the causal
        slice [m-1, m-1+n_out) of the linear convolution of ``ext``, as
        ``like``'s dtype; (P, n_out) for a bank."""
        m, n = self.m, ext.shape[-1]
        planes = False
        if self.fft_len >= n:
            # Long-kernel / short-chunk regime: one whole-extent FFT.
            h, _ = self._held_taps(ext, 0)
            size = conv_ops.next_power_of_two(n + m - 1)
            y = torch.fft.ifft(torch.fft.fft(ext, n=size)
                               * torch.fft.fft(h, n=size))
        else:
            fl_k = (conv_ops._kernel_fft_len(n, m, self.fft_len)
                    if ext.dtype in (torch.float32, torch.complex64)
                    and ext.dim() == 1 else 0)
            h, H = self._held_taps(ext, fl_k)
            if not fl_k:
                # a bank's rows broadcast against the signal's blocks
                y = conv_ops.blocked_linear_conv(
                    ext, h[:, None, :] if self.bank else h, self.fft_len)
            else:
                from .kernels import overlap_save_cuda
                # a bank reads a complex extension whole, the 1-D kernel
                # its planes
                cplx = ext.is_complex()
                xr, xi = ((ext.real, ext.imag) if cplx and not self.bank
                          else (ext, None))
                y = overlap_save_cuda.conv_blocks_cuda(
                    xr, xi, H, m, fl_k, linear=True, imag=cplx)
                planes = not self.bank
        with profiling.span("dsp.assemble"):
            y = y[..., m - 1:m - 1 + n_out]
            if planes:
                y = torch.complex(y[0], y[1]) if y.shape[0] == 2 else y[0]
            if not like.is_complex():
                y = y.real
            return y.to(like.dtype)

    def _count(self, chunk: torch.Tensor) -> None:
        if not (chunk.is_cuda and torch.cuda.is_current_stream_capturing()):
            StreamingFir.chunks += 1
            StreamingFir.rows += self.taps.shape[0] if self.bank else 1

    def process(self, chunk: torch.Tensor,
                state: FirState) -> Tuple[torch.Tensor, FirState]:
        """Processes one chunk; returns (out, new_state) with
        ``len(out) == len(chunk)``, (P, len(chunk)) for a bank.  A real
        chunk gives a real output.

        A chunk sharded on time over a mesh (a ``Shard(-1)`` ``DTensor``,
        the state the same on every rank) gives a ``Shard(-1)`` output:
        each rank extends its shard with the m-1 samples before it, from
        its left neighbour (``collectives.shift_from_left``) or, on the
        first rank, from the state's tail, and runs the same step; the new
        state, the chunk's last m-1 samples, reaches every rank in one
        all-gather.  A chunk whose shards are shorter than m-1 is gathered
        and its output sharded again."""
        from .vector import _sharded
        if _sharded(chunk):
            return self._process_sharded(chunk, state)
        tail = state.tail
        with profiling.span("dsp.stream", chunk):
            with profiling.span("dsp.extend"):
                ext = torch.cat([tail.to(chunk.dtype), chunk])
                # ext[len - (m - 1):], not ext[-(m - 1):], the whole array
                # at m == 1; a copy, not a view that would hold the whole
                # extension
                new_tail = ext[ext.shape[-1] - (self.m - 1):].to(
                    tail.dtype, copy=True)
            out = self._fir(ext, chunk.shape[-1], chunk)
            self._count(chunk)
        return out, FirState(tail=new_tail)

    def _process_sharded(self, chunk, state: FirState):
        from .parallel import collectives, sharded
        if self.bank:
            raise ValueError("StreamingFir: a bank of taps streams "
                             "unsharded chunks")
        mesh, axes = chunk.device_mesh, sharded.time_axes(chunk)
        halo = self.m - 1
        local = chunk.to_local()
        if local.shape[-1] < halo:
            out, state = self.process(chunk.full_tensor(), state)
            return sharded.shard_time_axis(out, mesh, axes), state
        tail = state.tail
        with collectives.on_mesh(mesh):
            if halo:
                left = collectives.shift_from_left(local[-halo:], axes,
                                                   wrap=False)
                if collectives.flat_index(axes) == 0:
                    left = tail
                last = collectives.all_gather(local[-halo:], axes)[-1]
            else:
                left = last = local[:0]
        ext = torch.cat([left.to(local.dtype), local])
        out = self._fir(ext, local.shape[-1], local)
        self._count(local)
        return (sharded._wrap(out.contiguous(), mesh, axes,
                              tuple(chunk.shape)),
                FirState(tail=last.to(tail.dtype, copy=True)))


def stream_chunks(fir: StreamingFir, x: torch.Tensor,
                  chunk_size: int) -> torch.Tensor:
    """Runs a whole signal through the streaming FIR chunk by chunk (the
    verification harness for chunked == whole-buffer).  A non-divisible
    tail is processed as one final shorter chunk: no samples dropped."""
    n = x.shape[-1]
    state = fir.init_state(x.dtype, x.device)
    pieces = []
    for start in range(0, n, chunk_size):
        out, state = fir.process(x[start:start + chunk_size], state)
        pieces.append(out)
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces)


class ResamplerState(NamedTuple):
    """Carry for the streaming resampler: the last ``T`` input samples."""

    tail: torch.Tensor


class _StreamPlan:
    """A :class:`StreamingResampler`'s in-place launch for (R, S) chunks of
    one dtype on one card, resolved once (:func:`_stream_plan`): the route
    (K5 ``resample_rowblock_cuda`` where ``interp_ops._takes_rowblock``
    holds at S + T, else K4 ``resample_direct_cuda``), the offsets and the
    float32 taps on the card, held with their pointers, resample_runs'
    geometry and the C entry (``resample_stream_launch``, or
    ``resample_stream_launch_complex`` for complex64).  A chunk whose tail
    the plan :meth:`admits` allocates the next tail and the output and
    passes the entry what ``resample_cuda._launch`` passes it, under the
    wrappers' route's spans (``dsp.rotate`` around the next tail's
    allocation, ``dsp.K5`` or ``dsp.K4`` around the launch, the entry
    called through ``_build.call``, which times it into that span's
    ``launch_ns`` while a profiler is active), counted in the wrapper's
    ``launches`` (and ``complex_launches``) and the stream's counters."""

    def __init__(self, rs: "StreamingResampler", R: int, S: int, dtype,
                 device):
        P, Q, L, T = rs.P, rs.Q, rs.L, rs.T
        record = resample_cuda._offsets(P, Q, rs.offs)
        self.cplx = dtype is torch.complex64
        if interp_ops._takes_rowblock(P, Q, L, S + T):
            self.wrapper, self.span = (resample_cuda.resample_rowblock_cuda,
                                       "dsp.K5")
        else:
            self.wrapper, self.span = (resample_cuda.resample_direct_cuda,
                                       "dsp.K4")
        self.dtype, self.device, self.index = dtype, device, device.index
        self.rows, self.shape, self.tail_shape = R, (R, S), (R, T)
        out_len = S * P // Q
        self.out_shape = (R, out_len)
        offs = resample_cuda.device_offs(record, device)
        taps = resample_cuda.launch_taps(rs.taps, device)
        # the held tensors stay alive while the plan points at them
        self.held = (offs, taps)
        lib = resample_cuda._lib()
        self.entry = (lib.resample_stream_launch_complex if self.cplx
                      else lib.resample_stream_launch)
        self.error_string = lib.resample_error_string
        self.lengths = (S, T, taps.data_ptr(), offs.data_ptr())
        self.geometry = (out_len, R, P, Q, L,
                         *resample_cuda._geometry(record, P, Q, L,
                                                  self.cplx)[:5])

    def admits(self, chunk, tail) -> bool:
        """Whether a chunk and its tail take the plan: a (R, S) chunk and
        a (R, T) tail of the plan's dtype on its card, each row's samples
        in order in both (last stride 1), neither with a conjugate bit,
        and neither requiring grad under grad mode (which the wrappers
        refuse)."""
        return (chunk.dtype is self.dtype and tail.dtype is self.dtype
                and chunk.shape == self.shape
                and tail.shape == self.tail_shape
                and chunk.get_device() == self.index
                and tail.get_device() == self.index
                and chunk.stride(-1) == 1 and tail.stride(-1) == 1
                and not chunk.is_conj() and not tail.is_conj()
                and not (torch.is_grad_enabled()
                         and (chunk.requires_grad or tail.requires_grad)))

    def __call__(self, chunk, tail):
        """(out, next tail) of the chunk, inside its root span."""
        counted = not torch.cuda.is_current_stream_capturing()
        with profiling.span("dsp.rotate"):
            new_tail = torch.empty(self.tail_shape, dtype=self.dtype,
                                   device=self.device)
        with profiling.span(self.span):
            out = torch.empty(self.out_shape, dtype=self.dtype,
                              device=self.device)
            if torch.cuda.current_device() == self.index:
                rc = self._issue(chunk, tail, new_tail, out)
            else:
                with torch.cuda.device(self.index):
                    rc = self._issue(chunk, tail, new_tail, out)
            _build.check_launch("resample", self.error_string, rc)
            if counted:
                self.wrapper.launches += 1
                if self.cplx:
                    self.wrapper.complex_launches += 1
        # host work only: the root still ends at its last child's marker
        if counted:
            StreamingResampler.chunks += 1
            StreamingResampler.rows += self.rows
            StreamingResampler.in_place += 1
            StreamingResampler.planned_chunks += 1
        return out, new_tail

    def _issue(self, chunk, tail, new_tail, out) -> int:
        return _build.call(self.entry, chunk.data_ptr(), chunk.stride(0),
                           tail.data_ptr(), tail.stride(0),
                           new_tail.data_ptr(), *self.lengths,
                           out.data_ptr(), *self.geometry,
                           _build._raw_stream(self.index))


def _stream_plan(rs: "StreamingResampler", chunk) -> "_StreamPlan | None":
    """A :class:`_StreamPlan` of ``rs`` for chunks of ``chunk``'s shape,
    dtype and card, or None where they do not take the in-place launch:
    off the card, not (R, S) with R >= 1, a dtype the card does not read
    in place at the geometry (float64; 2L+1 > 32), S not a positive
    multiple of 128*Q (which the chunk checks refuse), or taps requiring
    grad."""
    if (not chunk.is_cuda or chunk.dim() != 2
            or chunk.dtype not in rs._in_place
            or rs.taps.requires_grad):
        return None
    R, S = chunk.shape
    if R < 1 or S < 1 or S % (128 * rs.Q):
        return None
    return _StreamPlan(rs, R, S, chunk.dtype, chunk.device)


# Denominators up to 512, interpolatef's own bound (``interp_ops._branch``);
# the JAX package stops at 64, where its dense band matrix M (W x 128 P
# floats, built per resampler) still fits: at 160/147 it would be 1.55 GB.
# The port builds no M, so a factor that JAX refuses here (44.1 -> 48 kHz)
# streams; every factor JAX takes gives JAX's results.
_MAX_DEN = 512


class StreamingResampler:
    """Chunked fractional resampler for rational factors ``P/Q``: the
    streaming counterpart of ``interpolatef``.

    Each chunk of ``S`` input samples (``S`` divisible by ``128*Q``) yields
    exactly ``S*P//Q`` output samples, ``out[i] = sum_t ext[(i//P)*Q +
    offs[i%P] + t] * taps[i%P, t]`` over the tail-extended chunk ``ext``
    (JAX ``_direct_apply``).  The concatenated outputs equal the *linear*
    (zero-padded) resample of the concatenated input, delayed by
    ``self.output_delay`` samples.

    ``T`` and ``output_delay`` are the JAX package's, from the band
    matrix's row count ``interp_ops._band_W(P, Q, L, 128)``; the matrix
    itself is not built (18944 x 20480 float32 at 160/147), so ``Q`` may
    reach 512 where JAX stops at 64.  The resampler
    kernels read ``x[((i//P)*Q + offs + t - L) mod n]`` of ``ext`` rotated
    left by L, ``[tail[L:], chunk, tail[:L]]``.  A float32 or complex64
    chunk whose geometry runs on ``resample_runs`` (2L+1 <= 32) hands the
    wrapper its tail apart: on the card the kernel reads tail and chunk
    where they lie and writes the output and the new tail, the last T
    samples of [tail, chunk], into fresh tensors of the chunk's dtype in
    the same launch (complex64 interleaved, as it lies: no planes stacked
    or joined; on the CPU the wrapper builds the rotation).  float64
    chunks and the other geometries (2L+1 > 32) build the rotation with
    one concatenation, and keep the new tail as a view of it (S + T
    samples a channel) until the next chunk.  No state's tail
    is ever written.  The taps are sampled in float32 on ``device`` (the
    card when None).

    A block of channels streams as one: a (C, S) chunk with a (C, T) tail
    (``init_state(channels=C)``) is one kernel launch of C rows a chunk.

    On a card the resampler resolves its in-place launch once
    (:class:`_StreamPlan`, for the shape, dtype and card of the first
    (C, S) chunk read in place, and dropped when an attribute of the
    resampler is replaced): a chunk the plan admits, with its tail, is
    checked alone and issues K4 or K5 itself, adding one to
    ``StreamingResampler.planned_chunks`` (none while a CUDA graph is
    captured).  Any other chunk (CPU, 1-D, float64, 2L+1 > 32, a
    conjugate or strided row, another shape or card, a tail of another
    dtype, shape or card, grad) takes the wrappers' route; both give the
    same bits.
    """

    chunks = 0
    rows = 0
    #: float32 and complex64 chunks whose tail and chunk the wrapper took
    #: apart (read in place on the card)
    in_place = 0
    #: chunks that a held launch plan issued
    planned_chunks = 0

    def __init__(self, fun, factor: float, delay: float = 0.0,
                 conv_len: int = 10, device=None):
        self._launch_plan = None
        P, Q = interp_ops.parse_rational_factor(factor, "StreamingResampler",
                                                _MAX_DEN)
        L = int(conv_len)
        taps, offs = interp_ops.polyphase_taps(fun, P, Q, delay, L,
                                               torch.float32, device)
        if taps.is_complex():
            raise ValueError("StreamingResampler needs concrete real taps")
        self.taps, self.offs = taps, offs
        self.P, self.Q, self.L = P, Q, L
        self.c = interp_ops._choose_c(P, Q)
        W = interp_ops._band_W(P, Q, L, 128)
        # Tail length: window lookback (2L) and the band matrix's reach
        # (W - 128), rounded so (T - L) % Q == 0 keeps the output grid
        # aligned to whole polyphase cycles.
        T0 = max(2 * L, W - 128, 0)
        self.T = T0 + ((L - T0) % Q)
        #: concatenated-output delay vs the whole-buffer linear resample
        self.output_delay = (self.T - L) // Q * P
        # the chunk dtypes read in place
        self._in_place = frozenset(
            dt for dt in (torch.float32, torch.complex64)
            if resample_cuda.reads_in_place(P, Q, L, offs, dt))

    def __setattr__(self, name, value):
        # the plan holds what it was built from
        if name != "_launch_plan":
            self.__dict__["_launch_plan"] = None
        super().__setattr__(name, value)

    def __getstate__(self):
        # a copy builds its own plan
        return dict(self.__dict__, _launch_plan=None)

    def init_state(self, dtype=torch.complex64, device=None,
                   channels=()) -> ResamplerState:
        """Zero tail of ``T`` samples of ``dtype`` on ``device`` (the taps'
        when None) for chunks of leading shape ``channels`` (an int or a
        tuple; () for 1-D chunks): (*channels, T)."""
        lead = (channels,) if isinstance(channels, int) else tuple(channels)
        dev = self.taps.device if device is None else device
        return ResamplerState(tail=torch.zeros(lead + (self.T,), dtype=dtype,
                                               device=dev))

    def process(self, chunk: torch.Tensor,
                state: ResamplerState) -> Tuple[torch.Tensor, ResamplerState]:
        """Processes one chunk of shape (..., S) (``S % (128*Q) == 0``), a
        channel a row, with a tail of shape (..., T); returns (out,
        new_state) with ``out.shape[-1] == S*P//Q``.  Every channel of the
        chunk resamples in the one kernel launch."""
        plan = self._launch_plan
        if plan is None:
            plan = self._launch_plan = _stream_plan(self, chunk)
        if plan is not None and plan.admits(chunk, state.tail):
            with profiling.span("dsp.resample_stream", chunk):
                out, new_tail = plan(chunk, state.tail)
            return out, ResamplerState(tail=new_tail)
        S = chunk.shape[-1]
        span = 128 * self.Q
        if S % span != 0:
            raise ValueError(f"chunk length {S} must be divisible by "
                             f"128*Q = {span}")
        L, T = self.L, self.T
        if state.tail.shape != chunk.shape[:-1] + (T,):
            raise ValueError(
                f"StreamingResampler: a tail of shape "
                f"{tuple(state.tail.shape)} does not carry chunks of shape "
                f"{tuple(chunk.shape)}: init_state(channels="
                f"{tuple(chunk.shape[:-1])})")
        # the casts only where the state keeps another dtype than the
        # chunk's (a no-op `to` still costs the host a dispatch)
        cast = state.tail.dtype != chunk.dtype
        in_place = S and chunk.dtype in self._in_place
        out_len = S * self.P // self.Q
        with profiling.span("dsp.resample_stream", chunk):
            with profiling.span("dsp.rotate"):
                tail = state.tail.to(chunk.dtype) if cast else state.tail
                if in_place:
                    new_tail = torch.empty(tail.shape, dtype=tail.dtype,
                                           device=tail.device)
                else:
                    rotated = torch.cat([tail[..., L:], chunk,
                                         tail[..., :L]], dim=-1)
                    # the next tail, the last T samples of [tail, chunk]: a
                    # view of the extension this call made (no copy, and
                    # none of the caller's chunk held)
                    new_tail = (rotated[..., S - L:S - L + T] if S >= L
                                else torch.cat([tail[..., S:], chunk],
                                               dim=-1))
            if in_place:
                out = interp_ops._interpolatef_stream(
                    chunk, tail, new_tail, self.taps, self.P, self.Q,
                    self.offs, L, out_len)
            else:
                out = interp_ops._interpolatef_direct(
                    rotated, self.taps, self.P, self.Q, self.offs, L,
                    out_len, self.c)
            if cast:
                new_tail = new_tail.to(state.tail.dtype)
            # host work only: the root still ends at its last child's marker
            if not (chunk.is_cuda
                    and torch.cuda.is_current_stream_capturing()):
                StreamingResampler.chunks += 1
                StreamingResampler.rows += math.prod(chunk.shape[:-1])
                StreamingResampler.in_place += bool(in_place)
        if out.dtype != chunk.dtype:
            out = out.to(chunk.dtype)
        return out, ResamplerState(tail=new_tail)
