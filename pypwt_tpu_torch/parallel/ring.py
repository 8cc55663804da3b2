"""The port's exchanges between shards: its stand-in for JAX's
``jax.lax.ppermute`` and ``psum`` inside ``shard_map``.

JAX's sharded transforms are SPMD programs: each shard calls ``ppermute``
and XLA moves the operand over the chips' links.  The port's transforms
are level-synchronous loops over a list of shards instead
(``parallel.spatial``), and a *ring* moves the tensors.  One interface, two
implementations, both counting what they do:

* ``LocalRing`` runs in one process and holds one tensor per shard on its
  mesh device.  ``ppermute`` moves list entries with ``.to(device,
  non_blocking=True)``: between two cards a peer copy ordered on both
  devices' current streams, on one device (virtual shards) the tensor
  itself, no copy.  ``all_reduce_sum`` adds the shards' partial sums.
* ``ProcessGroupRing`` holds one shard per rank of a ``torch.distributed``
  process group: ``ppermute`` is ``dist.batch_isend_irecv`` of the halo
  slices, ``all_reduce_sum`` is ``dist.all_reduce`` (gloo on the CPU, NCCL
  on GPUs).

A ring's shards are ordered group-major: ``axis_size`` consecutive shards
form one ring (the mesh's ``rows`` axis), and a stack over ``data`` x
``rows`` holds several independent rings that every exchange serves at
once, as one JAX ``ppermute`` over the rows axis does.  A ring may also
take every ``stride``-th shard: a (rows, cols) grid lists its shards
row-major, so its ``cols`` rings are consecutive shards and its ``rows``
rings have stride ``n_cols``; ``GridRings`` holds the two and a ring of all
shards for the norms (``ProcessGroupRing.grid``: one process group per row
and per column).  ``counts`` holds
the calls of each collective (``ppermute``, ``all_gather``,
``all_reduce``, ``all_to_all``: the port makes no all-gather or
all-to-all) and ``ppermute_elems`` the elements one shard sends in each
``ppermute``; ``parallel.audit`` reads them.

The split and gather helpers carry whole tensors and pyramids to and from
shards: ``shard_rows``/``gather_rows`` (the row layout),
``shard_grid``/``gather_grid`` (both image axes), ``shard_last``/
``gather_last`` (a signal along its samples) and
``pyramid_to_shards``/``pyramid_from_shards`` (a sharded pyramid holds a
list of shards at each leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import COL_AXIS, ROW_AXIS

COLLECTIVES = ("ppermute", "all_gather", "all_reduce", "all_to_all")


class _Counted:
    def reset(self):
        """Set every count to 0."""
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.ppermute_elems = []

    def _count_ppermute(self, parts):
        self.counts["ppermute"] += 1
        self.ppermute_elems.append(parts[0].numel())


class LocalRing(_Counted):
    """Shards held by one process, ``devices[i]`` the device of shard i,
    in rings of ``axis_size`` shards ``stride`` apart: shard
    ``g * axis_size * stride + p * stride + q`` is position p of ring
    (g, q) (stride 1: consecutive shards)."""

    def __init__(self, devices, axis_size, stride=1):
        self.devices = [torch.device(d) for d in devices]
        self.axis_size = int(axis_size)
        self.stride = int(stride)
        if (self.axis_size < 1 or self.stride < 1
                or len(self.devices) % (self.axis_size * self.stride)):
            raise ValueError(f"{len(self.devices)} shards in rings of "
                             f"{self.axis_size}, stride {self.stride}")
        self.reset()

    @classmethod
    def for_mesh(cls, mesh, batched=True):
        """The ring over ``mesh``'s rows axis: of every (data, rows) shard
        for a stack (``batched``), of the first data index's row shards for
        one image."""
        devs = mesh.devices if batched else mesh.devices[:1]
        return cls(list(np.asarray(devs).reshape(-1)), mesh.shape[ROW_AXIS])

    def ppermute(self, parts, perm):
        """Shard ``dst`` of every ring receives shard ``src``'s tensor, for
        each (src, dst) of ``perm`` (a permutation of the ring)."""
        n, st = self.axis_size, self.stride
        out = [None] * len(parts)
        for g in range(0, len(parts), n * st):
            for q in range(g, g + st):
                for src, dst in perm:
                    i, j = q + src * st, q + dst * st
                    out[j] = parts[i].to(self.devices[j], non_blocking=True)
        self._count_ppermute(parts)
        return out

    def all_reduce_sum(self, values):
        """The sum of the shards' partial sums (0-d tensors), on the first
        shard's device."""
        self.counts["all_reduce"] += 1
        dev = self.devices[0]
        return sum(v.to(dev) for v in values)


class ProcessGroupRing(_Counted):
    """One shard per rank of ``group`` (the default group if None): the
    ring is the group, in rank order."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.axis_size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.reset()

    def _peer(self, r):
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def ppermute(self, parts, perm):
        """``parts`` is this rank's one tensor; it goes to the rank ``perm``
        sends it to, and the tensor of the rank that sends here comes
        back."""
        dist = self._dist
        (x,) = parts
        dst = next(d for s, d in perm if s == self.rank)
        src = next(s for s, d in perm if d == self.rank)
        if dst == self.rank:
            out = x
        else:
            x = x.contiguous()
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, self._peer(dst), self.group),
                   dist.P2POp(dist.irecv, out, self._peer(src), self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self._count_ppermute(parts)
        return [out]

    def all_reduce_sum(self, values):
        """The sum over the ranks of this rank's partial sum."""
        (v,) = values
        t = v.clone()
        self._dist.all_reduce(t, op=self._dist.ReduceOp.SUM, group=self.group)
        self.counts["all_reduce"] += 1
        return t

    @classmethod
    def grid(cls, n_rows, n_cols):
        """This rank's ``GridRings`` in a world of n_rows * n_cols ranks,
        rank i n_cols + j holding the shard at row i and column j: every
        rank creates every column's and every row's group, in one order, as
        ``torch.distributed.new_group`` asks."""
        import torch.distributed as dist
        rank = dist.get_rank()
        rows = cols = None
        for j in range(n_cols):
            g = dist.new_group([i * n_cols + j for i in range(n_rows)])
            if rank % n_cols == j:
                rows = cls(g)
        for i in range(n_rows):
            g = dist.new_group([i * n_cols + j for j in range(n_cols)])
            if rank // n_cols == i:
                cols = cls(g)
        return GridRings(rows, cols, cls())


class GridRings:
    """The rings of a (rows, cols) grid of shards, listed row-major: ``rows``
    (the shards of one column), ``cols`` (the shards of one row) and
    ``world`` (all of them: the norms' all-reduce).  ``counts``,
    ``ppermute_elems`` and ``reset`` cover the three, so
    ``audit.schedule_of`` reads a grid transform's whole schedule."""

    def __init__(self, rows, cols, world):
        self.rows, self.cols, self.world = rows, cols, world

    @classmethod
    def for_mesh(cls, mesh):
        """The LocalRings of a ``make_mesh2d`` mesh."""
        devs = list(np.asarray(mesh.devices).reshape(-1))
        n_cols = mesh.shape[COL_AXIS]
        return cls(LocalRing(devs, mesh.shape[ROW_AXIS], n_cols),
                   LocalRing(devs, n_cols), LocalRing(devs, len(devs)))

    def _rings(self):
        return (self.rows, self.cols, self.world)

    def reset(self):
        for r in self._rings():
            r.reset()

    @property
    def counts(self):
        return {k: sum(r.counts[k] for r in self._rings())
                for k in COLLECTIVES}

    @property
    def ppermute_elems(self):
        return [e for r in self._rings() for e in r.ppermute_elems]

    def all_reduce_sum(self, values):
        """The sum of every shard's partial sum."""
        return self.world.all_reduce_sum(values)


# -- split and gather --------------------------------------------------------


def shard_rows(tensor, mesh):
    """The shards of a whole tensor on ``mesh``: a stack (B, Nr, Nc) with
    its batch over ``data`` and its rows over ``rows`` (group-major, the
    order of ``LocalRing.for_mesh(mesh)``), one image (Nr, Nc) with its
    rows over the first data index's ``rows`` devices; each shard a
    contiguous tensor on its device."""
    t = torch.as_tensor(tensor)
    n_rows = mesh.shape[ROW_AXIS]
    if t.ndim == 3:
        groups = list(torch.tensor_split(t, mesh.devices.shape[0], 0))
        devices = np.asarray(mesh.devices).reshape(-1)
    else:
        groups = [t]
        devices = np.asarray(mesh.devices)[0]
    parts = [p for g in groups for p in torch.tensor_split(g, n_rows, -2)]
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def gather_rows(parts, n_rows=None, device=None):
    """The whole tensor of ``parts`` (rings of ``n_rows`` row shards, all of
    them one ring if None; the rings' stacks along the batch axis), on
    ``device`` (the first shard's if None)."""
    device = parts[0].device if device is None else torch.device(device)
    n = len(parts) if n_rows is None else n_rows
    rings = [torch.cat([p.to(device) for p in parts[g:g + n]], -2)
             for g in range(0, len(parts), n)]
    return rings[0] if len(rings) == 1 else torch.cat(rings, 0)


def shard_grid(tensor, mesh):
    """The shards of one image (Nr, Nc) on a (rows, cols) mesh: block
    (i, j) on ``mesh.devices[i, j]``, listed row-major (the order of
    ``GridRings.for_mesh``), each a contiguous tensor."""
    t = torch.as_tensor(tensor)
    parts = [q for p in torch.tensor_split(t, mesh.shape[ROW_AXIS], -2)
             for q in torch.tensor_split(p, mesh.shape[COL_AXIS], -1)]
    devices = np.asarray(mesh.devices).reshape(-1)
    return [p.to(d).contiguous() for p, d in zip(parts, devices)]


def gather_grid(parts, n_cols, device=None):
    """The whole image of a grid's row-major ``parts`` (``n_cols`` per
    row), on ``device`` (the first shard's if None)."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([torch.cat([p.to(device) for p in parts[i:i + n_cols]],
                                -1) for i in range(0, len(parts), n_cols)],
                     -2)


def rows_axis_devices(mesh):
    """The devices along ``mesh``'s rows axis at index 0 of its other
    axes (one ring)."""
    d = np.asarray(mesh.devices)
    ax = mesh.axis_names.index(ROW_AXIS)
    return list(np.moveaxis(d, ax, -1).reshape(-1, d.shape[ax])[0])


def rows_ring(mesh):
    """The ``LocalRing`` of ``rows_axis_devices`` (a sequence layout's
    ring)."""
    return LocalRing(rows_axis_devices(mesh), mesh.shape[ROW_AXIS])


def shard_last(tensor, mesh):
    """The shards of a signal (n,), or rows (B, n), split along their
    samples over ``mesh``'s rows axis (the sequence layout), each a
    contiguous tensor on its device."""
    t = torch.as_tensor(tensor)
    parts = torch.tensor_split(t, mesh.shape[ROW_AXIS], -1)
    return [p.to(d).contiguous()
            for p, d in zip(parts, rows_axis_devices(mesh))]


def gather_last(parts, device=None):
    """The whole signal (or rows) of sequence ``parts``, on ``device`` (the
    first shard's if None)."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(device) for p in parts], -1)


def gather_batch(parts, device=None):
    """The whole stack of data-parallel ``parts`` (one shard per data
    index), on ``device`` (the first shard's if None)."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(device) for p in parts], 0)


def _map_leaves(pyr, fn):
    out = [fn(pyr[0])]
    for c in pyr[1:]:
        out.append(tuple(fn(s) for s in c) if isinstance(c, tuple)
                   else fn(c))
    return out


def pyramid_to_shards(pyr, mesh, split=shard_rows):
    """A pyramid of whole tensors (or numpy arrays, e.g. the JAX package's
    outputs through ``np.asarray``) as a sharded pyramid: each leaf split
    by ``split`` (``shard_rows``, ``shard_grid`` or ``shard_last``)."""
    return _map_leaves([pyr[0]] + [tuple(c) if isinstance(c, (tuple, list))
                                   else c for c in pyr[1:]],
                       lambda t: split(t if isinstance(t, torch.Tensor)
                                       else torch.tensor(np.asarray(t)),
                                       mesh))


def pyramid_from_shards(pyr, n_rows=None, device=None, gather=None):
    """The whole-tensor pyramid of a sharded one: ``gather`` (a function
    of a leaf's shards) of each leaf, ``gather_rows`` if None."""
    if gather is None:
        return _map_leaves(pyr, lambda parts: gather_rows(parts, n_rows,
                                                          device))
    return _map_leaves(pyr, gather)


def per_shard(pyr):
    """A sharded pyramid as one pyramid per shard (the layout of
    ``core.thresh``)."""
    n = len(pyr[0])
    return [_map_leaves(pyr, lambda parts, i=i: parts[i]) for i in range(n)]


def from_per_shard(pyrs):
    """The inverse of ``per_shard``."""
    first = pyrs[0]
    out = [[p[0] for p in pyrs]]
    for lev in range(1, len(first)):
        if isinstance(first[lev], (tuple, list)):
            out.append(tuple([p[lev][k] for p in pyrs]
                             for k in range(len(first[lev]))))
        else:
            out.append([p[lev] for p in pyrs])
    return out
