"""The mesh/layout contract: ``Runtime``, the ``Mesh`` of ranks and the
``P`` partition spec.

The port of the JAX package's ``dist/sharding.py``.  Model, train and
data code programs against *logical* axis names:

* ``"fsdp"`` — the data/ZeRO axes (batch sharding + parameter sharding);
  may span several mesh axes (multi-pod: ``("pod", "data")``);
* ``"tp"``   — the tensor-parallel (model) axis; resolves to nothing when
  TP is disabled or the mesh has no model axis.

``Runtime`` resolves those names to the concrete mesh, applies the
divide-or-replicate rule (an axis entry is dropped when the dimension is
not divisible by the axis size), and degrades to single-device no-ops
when ``mesh=None``, bit for bit the one-device behaviour of the port
before it had a mesh.  Layout knobs, as there: ``tp_disabled`` (the model
axis folded into the data axes), ``sequence_parallel`` (the residual
stream's sequence split over the model axis between blocks) and
``collective_dtype`` (the wire dtype of gradient reductions).  The JAX
package's ``moe_mode`` (expert parallelism, ROADMAP A13.5.3c) and
``seq_sharded_decode`` (A13.5.3d) come with the bodies that read them.
:meth:`Runtime.local` stands for the JAX package's ``shard`` and
``shard_spec`` constraints, read as this contract reads a layout: the
rank's slice of a tensor it holds whole, as a differentiable view.

A mesh step's body runs with no mesh, on the rank's rows and its
model-axis slices of the parameters (:meth:`Runtime.step_body`).  Its
Runtime carries what the body reads of the mesh, fields of the port's
own:

* ``batch_group`` (no model axis): the data ranks' process group, over
  which the experts' load-balance loss sums its statistics, so that it
  is the global batch's as under the JAX package's pjit step;
* ``model_group``, ``model_ranks`` and ``model_index`` (a model axis
  above 1): the rank's slice of the model axis, its global ranks in axis
  order and the rank's position on it.  The model-parallel bodies split
  a dimension over the axis where :meth:`Runtime.splits` says the
  divide-or-replicate rule splits it, and cross the axis through the
  region functions of :mod:`repro_torch.dist.collectives`, which count
  on ``model_wire``.

**The port's counterpart of a mesh** (the decision, and why):

* *Ranks are processes* of one ``torch.distributed`` world: gloo on the
  CPU and for ranks that share one card, nccl where each rank has its
  own card.
* *The mesh* is :class:`Mesh`: an array of global ranks with named axes,
  so that a device order can permute ranks.  It is a plain value: the
  spec builders (and their tests against the JAX package's
  ``AbstractMesh``) need no process group.  A reduction over a set of
  axes gets its process group from :meth:`Mesh.group`, made on first
  use by every rank (SPMD: all ranks reach the same calls in the same
  order); the ring collectives need none, they go point to point by
  global rank on the default group.  ``torch.distributed``'s
  ``DeviceMesh`` was not taken: it needs an initialised world to exist
  at all, and creates its groups when it is built.
* *A ``PartitionSpec``* is :class:`P`, a tuple of entries, each an axis
  name, a tuple of names or ``None``; it compares with the JAX package's
  by ``tuple(spec)``.
* *Arrays are explicit per-rank shards*: a rank holds the slice of each
  global tensor along the dims its spec names (:meth:`Runtime.local`),
  and :meth:`Runtime.gather` rebuilds the global tensor.  DTensor was not
  taken: its uneven ``Shard`` pads, where this contract divides or
  replicates, and the ring sums must keep the JAX package's order of
  adds bit for bit.
* :meth:`Runtime.shard_map` slices global inputs by their specs, runs
  the body on the local slices and gathers the outputs by theirs.
  Inside a body the model runs with ``Runtime()``, as the JAX package's
  manual regions do.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["P", "Mesh", "Runtime", "host_device_runtime", "tree_map_specs"]

# Logical entry names understood by spec()/spec_div().
_FSDP = "fsdp"
_TP = "tp"

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}

SpecEntry = Union[None, str]


class P(tuple):
    """A partition spec: one entry per dim, each ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim is split over their
    product, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def tree_map_specs(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over nested dicts of leaves and their specs."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Global ranks laid out on named axes: ``ranks`` has one dim per
    name in ``axis_names``.  Equality is identity (its process groups are
    its own)."""

    ranks: np.ndarray
    axis_names: Tuple[str, ...]
    _groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict, repr=False)

    def __post_init__(self):
        ranks = np.asarray(self.ranks, dtype=np.int64)
        object.__setattr__(self, "ranks", ranks)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if ranks.ndim != len(self.axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} for axes "
                             f"{self.axis_names}")
        if sorted(ranks.ravel().tolist()) != list(range(ranks.size)):
            raise ValueError("a mesh's ranks must be a permutation of "
                             f"0..{ranks.size - 1}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s coordinate on each axis."""
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def axis_index(self, axes: Sequence[str], rank: int) -> int:
        """Rank ``rank``'s row-major index over ``axes``."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def axis_ranks(self, axes: Sequence[str], rank: int) -> Tuple[int, ...]:
        """The global ranks that share ``rank``'s coordinates off
        ``axes``, in row-major order over ``axes``."""
        axes = tuple(axes)
        c = self.coords(rank)
        idx = tuple(slice(None) if a in axes else c[a]
                    for a in self.axis_names)
        sub = self.ranks[idx]          # the kept axes, in mesh order
        kept = [a for a in self.axis_names if a in axes]
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return tuple(int(r) for r in sub.ravel())

    def group(self, axes: Sequence[str]):
        """``(process group, its global ranks in row-major order over
        axes)`` of this rank's slice along ``axes``.  The first call for
        ``axes`` makes the groups of every slice, on every rank."""
        import torch.distributed as dist

        axes = tuple(axes)
        rank = dist.get_rank()
        if axes not in self._groups:
            mine = None
            others = [a for a in self.axis_names if a not in axes]
            seen = set()
            for r in self.ranks.ravel().tolist():
                key = tuple(self.coords(r)[a] for a in others)
                if key in seen:
                    continue
                seen.add(key)
                members = self.axis_ranks(axes, r)
                if len(members) == dist.get_world_size():
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(sorted(members))
                if rank in members:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes], self.axis_ranks(axes, rank)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Frozen distribution contract: mesh + logical layout knobs."""

    mesh: Optional[Mesh] = None
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    tp_disabled: bool = False
    collective_dtype: str = "bfloat16"
    sequence_parallel: bool = False
    # Inside a mesh step's body, which sees no mesh (``step_body``): the
    # process group whose ranks hold the rest of the batch.  The experts'
    # routing statistics sum over it, so that their load-balance loss is
    # the global batch's, as under the JAX package's pjit step.  None:
    # the rows are the whole batch.
    batch_group: Any = None
    # Inside a mesh step's body on a model axis above 1: the axis' process
    # group, its global ranks in axis order, the rank's position on it,
    # and the WireLog its region functions count on.
    model_group: Any = None
    model_ranks: Tuple[int, ...] = ()
    model_index: int = 0
    model_wire: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a Mesh of ranks "
                            f"(repro_torch.launch.mesh.make_mesh), got "
                            f"{type(self.mesh).__name__}")
        if self.mesh is not None:
            names = set(self.mesh.axis_names)
            missing = [a for a in self.data_axes if a not in names]
            if missing:
                raise ValueError(f"data_axes {missing} not in mesh axes "
                                 f"{tuple(self.mesh.axis_names)}")
        object.__setattr__(self, "model_ranks", tuple(self.model_ranks))
        if self.mesh is not None and (self.batch_group is not None
                                      or self.model_ranks):
            raise ValueError("batch_group and the model_* fields belong to "
                             "a mesh step's body, which runs without a "
                             "mesh")
        if self.model_ranks and not (
                self.model_group is not None
                and 0 <= self.model_index < len(self.model_ranks)):
            raise ValueError(f"model_ranks {self.model_ranks} need their "
                             f"group and an index in range, got "
                             f"{self.model_index}")
        if self.collective_dtype not in _DTYPES:
            raise ValueError(f"collective_dtype must be one of "
                             f"{sorted(_DTYPES)}, got "
                             f"{self.collective_dtype!r}")

    # ---- axis resolution -----------------------------------------------------
    @functools.cached_property
    def _mesh_sizes(self) -> dict:
        return dict(self.mesh.shape) if self.mesh is not None else {}

    @functools.cached_property
    def fsdp_axes(self) -> Tuple[str, ...]:
        """The mesh axes acting as data/ZeRO axes.  With ``tp_disabled``
        the model axis is folded in, whether or not the caller listed
        it."""
        axes = self.data_axes
        if (self.tp_disabled and self.model_axis in self._mesh_sizes
                and self.model_axis not in axes):
            axes = axes + (self.model_axis,)
        return axes

    @functools.cached_property
    def fsdp_size(self) -> int:
        if self.mesh is None:
            return 1
        return functools.reduce(
            operator.mul, (self._mesh_sizes[a] for a in self.fsdp_axes), 1)

    @functools.cached_property
    def tp_size(self) -> int:
        if (self.mesh is None or self.tp_disabled
                or self.model_axis in self.fsdp_axes):
            return 1
        return int(self._mesh_sizes.get(self.model_axis, 1))

    @property
    def model_size(self) -> int:
        """The model axis a mesh step's body sees: its size, 1 outside a
        body or without a model axis."""
        return max(len(self.model_ranks), 1)

    def splits(self, dim: int) -> bool:
        """Whether a body's dimension of ``dim`` entries, laid out on
        ``"tp"``, is split over its model axis: the divide-or-replicate
        rule of :meth:`spec_div`."""
        return self.model_size > 1 and int(dim) % self.model_size == 0

    @property
    def fsdp(self):
        """Spec entry for the data axes: axis name, tuple of names, or
        None on a single device."""
        if self.mesh is None:
            return None
        axes = self.fsdp_axes
        return axes if len(axes) > 1 else axes[0]

    @property
    def tp(self):
        """Spec entry for the model axis when TP is active; ``False``
        otherwise (the resolvers map ``"tp"`` to None then)."""
        return self.model_axis if self.tp_size > 1 else False

    def _resolve(self, entry: SpecEntry):
        if entry is None:
            return None
        if entry == _FSDP:
            return self.fsdp
        if entry == _TP:
            return self.tp or None
        # raw mesh-axis name: pass through if it exists, else replicate
        return entry if entry in self._mesh_sizes else None

    def _entry_size(self, entry: SpecEntry) -> int:
        if entry is None:
            return 1
        if entry == _FSDP:
            return self.fsdp_size
        if entry == _TP:
            return self.tp_size
        return int(self._mesh_sizes.get(entry, 1))

    # ---- spec builders -------------------------------------------------------
    def spec(self, *entries: SpecEntry) -> P:
        """Partition spec from logical entries (no divisibility check)."""
        return P(*(self._resolve(e) for e in entries))

    def spec_div(self, entries: Sequence[SpecEntry],
                 shape: Sequence[int]) -> P:
        """Partition spec with the divide-or-replicate rule: an entry is
        kept only when the matching dimension is divisible by its axis
        size (and the axis is real, i.e. size > 1)."""
        if len(entries) != len(shape):
            raise ValueError(f"entries {entries!r} vs shape {shape!r}")
        out = []
        for e, d in zip(entries, shape):
            size = self._entry_size(e)
            out.append(self._resolve(e)
                       if size > 1 and int(d) % size == 0 else None)
        return P(*out)

    def data_spec(self, spec: P) -> P:
        """``spec`` with its model-axis entries replicated: the layout
        over the data axes alone, in which a rank holds its model-axis
        slice whole."""
        if self.tp_size == 1:
            return spec
        return P(*(None if e == self.model_axis else e for e in spec))

    def step_body(self, wire=None) -> "Runtime":
        """The Runtime that a mesh step's body runs with on this rank: no
        mesh; without a model axis the data ranks' ``batch_group``; on a
        model axis above 1 its ``model_*`` fields (``wire`` their
        WireLog) and ``sequence_parallel``.  On a model axis each data
        shard's rows are a batch of their own, as in the JAX package's
        manual model regions: the experts' load-balance loss is then each
        data shard's own, which the mesh step averages over the data
        ranks.  Makes the process groups it names, a collective call on
        every rank."""
        import torch.distributed as dist

        if self.tp_size == 1:
            return Runtime(batch_group=self.mesh.group(self.fsdp_axes)[0])
        mgroup, ranks = self.mesh.group((self.model_axis,))
        return Runtime(sequence_parallel=self.sequence_parallel,
                       model_group=mgroup, model_ranks=ranks,
                       model_index=ranks.index(dist.get_rank()),
                       model_wire=wire)

    # ---- per-rank shards -----------------------------------------------------
    def _rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank()

    def local(self, x: torch.Tensor, spec: P,
              rank: Optional[int] = None) -> torch.Tensor:
        """This rank's (or ``rank``'s) slice of the global tensor ``x``
        under ``spec``: dim ``j`` split into equal parts over the axes of
        entry ``j``, part = the rank's row-major index over them.  A view;
        ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        if len(spec) != x.dim():
            raise ValueError(f"spec {spec!r} for a tensor of shape "
                             f"{tuple(x.shape)}")
        rank = self._rank() if rank is None else rank
        for j, entry in enumerate(spec):
            axes = _axes_of(entry)
            if not axes:
                continue
            n = functools.reduce(operator.mul,
                                 (self._mesh_sizes[a] for a in axes), 1)
            if x.shape[j] % n:
                raise ValueError(f"dim {j} of {tuple(x.shape)} does not "
                                 f"divide over {axes} ({n})")
            per = x.shape[j] // n
            x = x.narrow(j, self.mesh.axis_index(axes, rank) * per, per)
        return x

    def gather(self, x: torch.Tensor, spec: P, log=None) -> torch.Tensor:
        """The global tensor from every rank's ``x`` under ``spec`` (a
        collective on the ranks of each sharded dim's axes); ``x``
        itself without a mesh or where ``spec`` replicates."""
        if self.mesh is None:
            return x
        from .collectives import all_gather

        for j, entry in enumerate(spec):
            axes = _axes_of(entry)
            if not axes:
                continue
            group, members = self.mesh.group(axes)
            x = torch.cat(all_gather(x, group, members, log), dim=j)
        return x

    def shard_map(self, f, *, in_specs, out_specs):
        """``f`` over per-rank slices: global inputs are sliced by
        ``in_specs`` (a spec tree per argument), ``f`` runs on the
        slices, and its outputs are gathered by ``out_specs`` (a spec
        tree, or one per output when ``f`` returns a tuple); a
        replicated output is the rank's own (never compared across
        ranks).  ``f`` itself on a single device."""
        if self.mesh is None:
            return f

        def wrapped(*args):
            local = [tree_map_specs(self.local, a, s)
                     for a, s in zip(args, in_specs)]
            out = f(*local)
            if isinstance(out, tuple):    # one spec tree per output
                return tuple(tree_map_specs(self.gather, o, s)
                             for o, s in zip(out, out_specs))
            return tree_map_specs(self.gather, out, out_specs)

        return wrapped

    # ---- misc ----------------------------------------------------------------
    def astype(self, x: torch.Tensor) -> torch.Tensor:
        """Cast to the collective wire dtype (``collective_dtype``)."""
        return x.to(_DTYPES[self.collective_dtype])


def host_device_runtime(devices: Optional[int] = None,
                        axis: str = "data") -> Runtime:
    """A :class:`Runtime` over a 1-D mesh of the default process group's
    world:

    * ``devices`` ``None`` or the world's size -> every rank of it;
    * ``devices <= 1``     -> ``Runtime()``, the single-device no-op;
    * more ranks than the world holds raises, naming the launch line
      (``torchrun --standalone --nproc-per-node N``) that makes them;
    * fewer ranks than the world holds, but more than one, raises: the
      ranks left out could reach no collective of the mesh, and those in
      it would wait on them to make its process groups.
    """
    import torch.distributed as dist

    avail = dist.get_world_size() if dist.is_initialized() else 1
    n = avail if devices is None else int(devices)
    if n <= 1:
        return Runtime(mesh=None, data_axes=(axis,))
    if n > avail:
        raise RuntimeError(
            f"asked for {n} ranks but the process group holds {avail}.  "
            f"Ranks are processes: start them with `torchrun --standalone "
            f"--nproc-per-node {n} -m ...` (every rank then calls "
            f"torch.distributed.init_process_group) before asking for "
            f"{n} devices.")
    if n < avail:
        raise ValueError(
            f"asked for {n} ranks of a world of {avail}: a mesh spans the "
            f"whole world (every rank makes its process groups); start "
            f"{n} ranks, or ask for 1 or {avail}")
    from ..launch.mesh import make_mesh
    return Runtime(mesh=make_mesh((n,), (axis,)), data_axes=(axis,))
