"""Channel-parallel MIMO convolution over a device mesh on
``torch.distributed`` (counterpart of ``basic_dsp_tpu/parallel/mimo.py``).

``matrix._convolve_mat`` mixes C input channels into C output channels
through a (C, C) grid of impulse responses, in the frequency domain.
Distributed form: the channel axis shards over the mesh, each rank FFTs
its input rows, contracts them against its column block of the kernel
grid's spectrum, and one reduce-scatter (``collectives.reduce_scatter``,
JAX's ``psum_scatter``) both sums the partial channel mixes and leaves
each rank its block of output channels: the (C, n) spectrum is never
gathered.  The reduce-scatter moves (d-1)/d of C*n complex samples a
rank, the traffic of one all-to-all.
"""
from __future__ import annotations

import torch

from ..ops import conv_ops
from . import collectives
from .sharded import _local, _wrap
from .sharded_fft import _complex_of


def sharded_convolve_mat(x, imp, mesh, axis_name=None):
    """Distributed ``matrix._convolve_mat``: ``out[c] = sum_r rows[r] (*)
    imp[c, r]``, the centered circular convolutions, with the rows of
    ``x`` (C, n) sharded over channels: a ``DTensor`` with ``Shard(0)``
    over the axes, or a tensor replicated on every rank, which is sliced.

    ``imp``: the (C, C, taps) kernel grid (out_channel, in_channel, tap),
    numpy or a tensor.  Requires ``C % mesh size == 0``.  Returns the (C,
    n) output as a ``Shard(0)`` ``DTensor``, real for real ``x``.  Each
    rank lays out and transforms its own column block ``G[:, r_local, :]``
    of the grid, once a call."""
    axes = collectives.resolve_axes(mesh, axis_name)
    C, n = x.shape
    d = collectives.mesh_size(mesh, axes)
    if C % d != 0:
        raise ValueError(
            f"sharded_convolve_mat: channel count {C} must divide by the "
            f"mesh size {d} (channel-sharding contract, docs/API.md)")
    if imp.ndim != 3 or imp.shape[0] != C or imp.shape[1] != C:
        raise ValueError("impulse_response must be (C, C, taps)")
    xl, _ = _local(x, mesh, axes, dim=0)
    cdtype = _complex_of(xl.dtype)
    with collectives.on_mesh(mesh):
        i = collectives.flat_index(axes)
    r0, r1 = i * C // d, (i + 1) * C // d
    Gl = torch.fft.fft(conv_ops.kernel_layout(
        torch.as_tensor(imp)[:, r0:r1].to(xl.device, cdtype), n),
        dim=-1)                                         # (C, C/d, n)
    X = torch.fft.fft(xl.to(cdtype), dim=-1)            # (C/d, n)
    partial = torch.einsum("crn,rn->cn", Gl, X)         # (C, n)
    with collectives.on_mesh(mesh):
        Y = collectives.reduce_scatter(partial, axes)   # (C/d, n)
    out = torch.fft.ifft(Y, dim=-1)
    if not xl.is_complex():
        out = out.real.to(xl.dtype)
    return _wrap(out.contiguous(), mesh, axes, (C, n), dim=0)
