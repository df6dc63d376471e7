"""Hierarchical (multi-host-shaped) collective helpers on
``torch.distributed`` (counterpart of
``basic_dsp_tpu/parallel/collectives.py``).

A mesh (``config.make_mesh``) is a ``DeviceMesh`` of one rank a device: a
1-D ``dsp`` mesh, or a 2-D ``(host, chip)`` mesh whose outer axis crosses
hosts.  Every sharded function addresses it through these helpers, which
take either one axis name or a tuple of names ordered outermost-first:
the time or channel axis shards over the flattened host-major rank order.

The JAX helpers run inside ``shard_map``, whose mesh is implicit.  Here a
rank computes on its own local tensor, and :func:`on_mesh` names the mesh
that :func:`flat_index`, :func:`flat_size` and the shifts address (the
counterpart of being inside a ``shard_map`` body over that mesh).

Communication:

* :func:`shift_from_left` / :func:`shift_from_right` (the halo exchange of
  the convolution, the resampler and the channelizer) are point-to-point:
  each rank sends its halo to its ring neighbour with one
  ``batch_isend_irecv``.  Only ranks on a host boundary send across
  hosts, and only the halo: the traffic JAX's hierarchical ppermute
  decomposition buys, in one step.
* reductions (``sharded.sharded_sum``, ``sharded.sharded_statistics``)
  all-reduce or all-gather over the innermost axis's group first, then
  the outer ones.
* :func:`all_to_all` (the distributed FFT's transposes) and
  :func:`reduce_scatter` (the MIMO convolution's channel mix) run over one
  process group of the flattened axes (:func:`_flat_group`), in
  host-major order: JAX's tiled ``all_to_all`` and ``psum_scatter`` over
  the same axes.
"""
from __future__ import annotations

import contextlib
import contextvars
import weakref
from typing import Sequence, Tuple, Union

import torch

AxisNames = Union[str, Tuple[str, ...]]

_MESH = contextvars.ContextVar("basic_dsp_tpu_torch_mesh", default=None)


def norm_axes(axis_name: AxisNames) -> Tuple[str, ...]:
    """Axis spec -> tuple ordered outermost-first."""
    if isinstance(axis_name, str):
        return (axis_name,)
    return tuple(axis_name)


def mesh_axes(mesh) -> Tuple[str, ...]:
    """All axis names of a mesh, outermost-first (the time-axis shard
    order)."""
    return tuple(mesh.mesh_dim_names)


def resolve_axes(mesh, axis_name: AxisNames = None) -> Tuple[str, ...]:
    """Default axis spec: every mesh axis (host-major).  An explicit name
    (or tuple) selects a sub-sharding; its axes must be in the mesh's
    order (a ``DTensor`` shards over mesh dimensions in mesh order)."""
    if axis_name is None:
        return mesh_axes(mesh)
    axes = norm_axes(axis_name)
    missing = [a for a in axes if a not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"axis {missing} not in mesh axes "
                         f"{mesh.mesh_dim_names}")
    dims = [mesh.mesh_dim_names.index(a) for a in axes]
    if dims != sorted(dims):
        raise ValueError(f"axes {axes} must be in the mesh's order "
                         f"{mesh.mesh_dim_names}")
    return axes


def _dim(mesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def mesh_size(mesh, axes: Sequence[str]) -> int:
    out = 1
    for size in axis_sizes(mesh, axes):
        out *= size
    return out


def axis_sizes(mesh, axes: Sequence[str]):
    shape = mesh.shape
    return tuple(int(shape[_dim(mesh, a)]) for a in norm_axes(tuple(axes)))


@contextlib.contextmanager
def on_mesh(mesh):
    """Within this context the collectives address ``mesh``: the port's
    counterpart of a ``shard_map`` body over it.  Nests; restored on
    exit."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _current_mesh():
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("collectives: no mesh; call inside "
                           "collectives.on_mesh(mesh), the counterpart of "
                           "a shard_map body")
    return mesh


# mesh -> {axes: (ranks, i)}: ``DeviceMesh.mesh`` builds its rank tensor
# anew at each access (tens of us), so each rank's rings are built once.
_RINGS = weakref.WeakKeyDictionary()


def _ring(mesh, axes: Tuple[str, ...]):
    """(ranks, i): the global ranks of this rank's ring over ``axes``
    (the other axes fixed at this rank's coordinates), in flattened
    host-major order, and this rank's position in it."""
    rings = _RINGS.setdefault(mesh, {})
    ring = rings.get(axes)
    if ring is None:
        ring = rings[axes] = _build_ring(mesh, axes)
    return ring


def _build_ring(mesh, axes: Tuple[str, ...]):
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("collectives: this rank is not in the mesh")
    dims = [_dim(mesh, a) for a in axes]
    sub = mesh.mesh
    index = [slice(None) if k in dims else c for k, c in enumerate(coord)]
    sub = sub[tuple(index)]            # the selected dims, in mesh order
    order = sorted(dims)
    sub = sub.permute([order.index(d) for d in dims]).reshape(-1)
    i = 0
    for d in dims:
        i = i * int(mesh.shape[d]) + coord[d]
    return [int(r) for r in sub.tolist()], i


def flat_index(axes: AxisNames) -> int:
    """Global host-major position of this rank along the flattened axes
    (inside :func:`on_mesh`)."""
    return _ring(_current_mesh(), norm_axes(axes))[1]


def flat_size(axes: AxisNames) -> int:
    return mesh_size(_current_mesh(), norm_axes(axes))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of ``t`` for the wire (complex as (..., 2))."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _shift(val: torch.Tensor, axes: AxisNames, wrap: bool,
           step: int) -> torch.Tensor:
    """Each rank receives ``val`` from its neighbour at ``-step`` along the
    flattened ring (step +1: from the left).  Without ``wrap`` the ring's
    first (step +1) or last (step -1) rank receives zeros, as ``ppermute``
    gives a rank with no source.  At ring size 1 the shift is the
    identity permutation: no message."""
    import torch.distributed as dist

    ranks, i = _ring(_current_mesh(), norm_axes(axes))
    d = len(ranks)
    src, dst = i - step, i + step
    has_src = wrap or 0 <= src < d
    has_dst = wrap or 0 <= dst < d
    if d == 1:
        return val.clone() if has_src else torch.zeros_like(val)
    out = torch.zeros_like(val)
    ops = []
    if has_dst:
        ops.append(dist.P2POp(dist.isend, _wire(val), ranks[dst % d]))
    if has_src:
        ops.append(dist.P2POp(dist.irecv, _wire(out), ranks[src % d]))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def shift_from_left(val: torch.Tensor, axes: AxisNames,
                    wrap: bool = True) -> torch.Tensor:
    """Each rank receives ``val`` from its LEFT neighbour in the flattened
    host-major ring (inside :func:`on_mesh`); ``wrap=False`` feeds zeros
    into the global first rank, the causal-padding edge the channelizer
    uses."""
    return _shift(val, axes, wrap, 1)


def shift_from_right(val: torch.Tensor, axes: AxisNames,
                     wrap: bool = True) -> torch.Tensor:
    """Mirror of :func:`shift_from_left`: receive from the RIGHT neighbour
    of the flattened ring; ``wrap=False`` gives the last rank zeros."""
    return _shift(val, axes, wrap, -1)


def _groups_inner_first(mesh, axes: Tuple[str, ...]):
    """(group, size) of each axis, innermost first: the order in which a
    reduction crosses the mesh (intra-host before inter-host)."""
    dims = [_dim(mesh, a) for a in reversed(axes)]
    return [(mesh.get_group(d), int(mesh.shape[d])) for d in dims]


def all_reduce_sum(t: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the flattened axes, on every one
    of them (``psum``), reduced innermost axis first."""
    import torch.distributed as dist

    out = t.clone().contiguous()
    for group, size in _groups_inner_first(_current_mesh(), norm_axes(axes)):
        if size > 1:
            dist.all_reduce(_wire(out), group=group)
    return out


def all_gather(t: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """(d, *t.shape): ``t`` of every rank of the flattened axes, in
    host-major order, on every one of them; gathered innermost axis
    first."""
    import torch.distributed as dist

    out = t.contiguous()[None]
    for group, size in _groups_inner_first(_current_mesh(), norm_axes(axes)):
        if size > 1:
            parts = [torch.empty_like(out) for _ in range(size)]
            dist.all_gather([_wire(p) for p in parts], _wire(out),
                            group=group)
            out = torch.cat(parts)
    return out


# mesh -> {axes: group}: one process group over the flattened axes,
# created once, collectively, on every rank of the ring.
_GROUPS = weakref.WeakKeyDictionary()


def _flat_group(mesh, axes: Tuple[str, ...]):
    """A process group over the ranks of this rank's ring over ``axes``
    whose group rank p is flat (host-major) position p.  One axis is the
    mesh's own group of that dimension; several are one new group a ring,
    created at the first call on every rank of the ring
    (``use_local_synchronization``: the other rings' ranks take no part)
    and cached per mesh and axes, as the rings are."""
    groups = _GROUPS.setdefault(mesh, {})
    group = groups.get(axes)
    if group is None:
        import torch.distributed as dist
        ranks, _ = _ring(mesh, axes)
        if len(axes) == 1:
            group = mesh.get_group(_dim(mesh, axes[0]))
        else:
            group = dist.new_group(ranks, use_local_synchronization=True)
        if [dist.get_group_rank(group, r) for r in ranks] != list(
                range(len(ranks))):
            raise ValueError("collectives: the mesh's ranks must increase "
                             "in host-major order, as make_mesh lays them")
        groups[axes] = group
    return group


def all_to_all(t: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """JAX's tiled ``all_to_all(split_axis=1, concat_axis=0)`` of the 2-D
    ``t`` (r, c) over the flattened axes (inside :func:`on_mesh`): column
    block j (c/d wide) goes to flat position j, and the blocks received
    stack along the rows in flat order, (d*r, c/d).  ``all_to_all_single``
    splits dim 0, so the column blocks are sent as the rows of
    ``t.reshape(r, d, c/d).permute(1, 0, 2)``.  At size 1 it sends
    nothing."""
    import torch.distributed as dist

    mesh, axes = _current_mesh(), norm_axes(axes)
    d = mesh_size(mesh, axes)
    if d == 1:
        return t
    r, c = t.shape
    send = t.reshape(r, d, c // d).permute(1, 0, 2).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_wire(recv), _wire(send),
                           group=_flat_group(mesh, axes))
    return recv.reshape(d * r, c // d)


def reduce_scatter(t: torch.Tensor, axes: AxisNames) -> torch.Tensor:
    """JAX's tiled ``psum_scatter(scatter_dimension=0)`` over the
    flattened axes (inside :func:`on_mesh`): the sum of ``t`` over their
    ranks, of which flat position i keeps row block i, (rows/d, ...).  At
    size 1 it is ``t``."""
    import torch.distributed as dist

    mesh, axes = _current_mesh(), norm_axes(axes)
    d = mesh_size(mesh, axes)
    if d == 1:
        return t
    out = torch.empty((t.shape[0] // d,) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    # torch 2.13 deprecates reduce_scatter_tensor in favour of
    # reduce_scatter_single (same arguments); earlier releases have only
    # the former.
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(_wire(out), _wire(t), group=_flat_group(mesh, axes))
    return out
