"""The partition layer: one mesh config and regex partition rules supply
every placement of the port's stock-sharded and member-sharded paths.

The counterpart of the JAX package's ``parallel/partition.py``. There a
mesh is a grid of ``jax.Device``s and a placement a ``NamedSharding`` that
GSPMD lowers; here:

* **a mesh** is a grid over the ranks of a ``torch.distributed`` process
  group, each rank owning one device. With no process group it is world
  size 1, the degenerate one-device mesh (:func:`device_mesh`). The grid
  may hold any hashable device identities (:func:`slice_devices` cuts
  sub-grids of them); by default it holds the group's ranks
  ``0 .. world - 1``;
* **a single-process mesh** holds ``torch.device``s instead: the devices
  of one process (:func:`local_devices`, the counterpart of
  ``jax.devices()``), as the mesh-packed sweep and the serving engine lay
  them out. There the Python API may name one device at several positions
  (a CPU test, or several spans on one card); :meth:`Mesh.positions`
  enumerates positions by index and :func:`position_device` gives each
  one's ``torch.device``, while :meth:`Mesh.position` stays strict;
* **a placement** is the port's own small class, :class:`PartitionSpec`
  (``P``): a tuple with one entry per array dimension, a mesh axis name
  (that dimension is split in contiguous spans over the axis) or None
  (replicated), as JAX's. ``torch.distributed.tensor``'s ``Shard(dim)`` /
  ``Replicate()`` are not used: they need a live ``DeviceMesh`` (a process
  group) before any rule can be matched, and nothing here runs DTensor
  operations; a :class:`Sharding` (mesh + spec) only says which span of
  each dimension a mesh position owns (:meth:`Sharding.devices_indices_map`);
* :func:`shard_batch` returns THIS rank's contiguous local slices of a
  batch (``torch.distributed`` has no global array to assemble): rank r of
  a 1-D ``stocks`` mesh gets the span ``[r·N/world, (r+1)·N/world)`` of the
  padded stock axis, the span JAX's ``NamedSharding`` gives device r.
  Beyond world size 1 every sharded batch carries ``n_assets``, the true
  global count, so a mean over stocks divides by it and not by the local N.

:func:`match_partition_rules` maps any nested dict/list/tuple of tensors
or arrays to specs by regex over the leaf's ``/``-joined path: scalars are
replicated without consulting the rules, the first matching rule wins, and
an unmatched leaf raises an error NAMING its path.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- canonical axis names ----------------------------------------------------

STOCK_AXIS = "stocks"    # shards the [T, N, F] panel's stock axis N
MEMBER_AXIS = "members"  # ensemble seed axis (leading axis of stacked params)
GRID_AXIS = "grid"       # sweep (lr × seed) grid axis
BATCH_AXIS = "batch"     # the legacy name of the member axis

_STACK_AXES = (MEMBER_AXIS, BATCH_AXIS, GRID_AXIS)


class PartitionSpec(tuple):
    """One entry per array dimension: a mesh axis name (split over that
    axis), a tuple of axis names (split over their product), or None
    (replicated). ``P()`` replicates a whole array."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def world_size() -> int:
    """The default process group's size; 1 without one."""
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def local_devices(route="cuda") -> Tuple[Any, ...]:
    """This process's devices of `route` (a device type or a device): every
    CUDA device torch sees, ``cuda:0 .. cuda:n-1``, or the one CPU device.
    Asking for CUDA without a card is an error naming it."""
    import torch

    kind = torch.device(route).type
    if kind == "cpu":
        return (torch.device("cpu"),)
    if kind != "cuda":
        raise ValueError(f"device must be cuda or cpu: {str(route)!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(route)!r} requested but torch finds no CUDA "
            "device; pass --device cpu (device='cpu') to run on the CPU")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def position_device(entry):
    """The ``torch.device`` of a single-process mesh entry (a device or its
    name); a rank mesh's integer entries name processes, not devices."""
    import torch

    if isinstance(entry, torch.device):
        return entry
    if isinstance(entry, str):
        return torch.device(entry)
    raise TypeError(f"mesh entry {entry!r} is not a device (a rank mesh "
                    "places each rank on its own device)")


def on_device(device):
    """A context making `device` current where it is a card (kernels and
    graphs launch on the current device's stream); nothing on the CPU."""
    import contextlib

    import torch

    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


# -- the mesh ------------------------------------------------------------------


class Mesh:
    """A named grid of device identities (the ranks, by default): the
    port's counterpart of ``jax.sharding.Mesh``. ``shape`` maps each axis
    name to its size, in axis order."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh grid of rank {devices.ndim} for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def position(self, device) -> Dict[str, int]:
        """{axis: index} of `device` in the grid."""
        hits = np.argwhere(self.devices == device)
        if len(hits) != 1:
            raise ValueError(f"{device!r} is not (once) in the mesh "
                             f"{self.devices.tolist()}")
        return dict(zip(self.axis_names, (int(i) for i in hits[0])))

    def positions(self) -> List[Tuple[Dict[str, int], Any]]:
        """Every position in row-major order as ({axis: index}, its device
        entry); unlike :meth:`position`, one device may hold several."""
        return [(dict(zip(self.axis_names, (int(i) for i in idx))),
                 self.devices[idx])
                for idx in np.ndindex(*self.devices.shape)]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __hash__(self) -> int:
        return hash((self.axis_names, tuple(self.devices.ravel().tolist())))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """One spec → one named device grid.

    ``axes`` is an ordered ``(name, size)`` tuple; a single size may be -1
    (fill with every remaining device). ``devices`` restricts the grid to an
    explicit slice; by default it is the process group's ranks.
    ``build()`` returns the :class:`Mesh`.
    """

    axes: Tuple[Tuple[str, int], ...]
    devices: Optional[Tuple[Any, ...]] = None

    def build(self) -> Mesh:
        devices = (list(self.devices) if self.devices is not None
                   else list(range(world_size())))
        sizes = [int(s) for _, s in self.axes]
        names = [str(n) for n, _ in self.axes]
        fills = [i for i, s in enumerate(sizes) if s == -1]
        if len(fills) > 1:
            raise ValueError(f"MeshConfig: at most one -1 axis: {self.axes}")
        fixed = int(np.prod([s for s in sizes if s != -1], dtype=np.int64))
        if fixed < 1:
            raise ValueError(f"MeshConfig: axis sizes must be >= 1: {self.axes}")
        if fills:
            if len(devices) // fixed < 1:
                raise ValueError(
                    f"MeshConfig {self.axes}: {fixed} fixed-size slots exceed "
                    f"the {len(devices)} available devices")
            sizes[fills[0]] = len(devices) // fixed
        total = int(np.prod(sizes, dtype=np.int64))
        if total > len(devices):
            raise ValueError(
                f"MeshConfig {tuple(zip(names, sizes))} needs {total} "
                f"devices, have {len(devices)}")
        grid = np.empty(total, dtype=object)
        grid[:] = devices[:total]
        return Mesh(grid.reshape(sizes), tuple(names))


def parse_mesh_spec(spec: str, devices: Optional[Sequence] = None
                    ) -> MeshConfig:
    """CLI mesh spec → :class:`MeshConfig`.

    Grammar: ``"stocks=4"``, ``"stocks=-1"`` (fill with every remaining
    device), ``"members=2,stocks=4"`` (axis order as written), or a bare
    integer ``"4"`` (shorthand for ``stocks=<n>``). ``devices`` restricts
    the grid to an explicit slice (:func:`slice_devices`' result)."""
    text = spec.strip()
    if not text:
        raise ValueError("empty mesh spec")
    axes = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            name, _, size = part.partition("=")
            name, size = name.strip(), size.strip()
        else:
            name, size = STOCK_AXIS, part
        if not name:
            raise ValueError(f"mesh spec axis missing a name: {spec!r}")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(
                f"mesh spec axis {name!r} has non-integer size {size!r} "
                f"in {spec!r}") from None
        if n == 0 or n < -1:
            raise ValueError(
                f"mesh spec axis {name!r} size must be >= 1 or -1 (fill): "
                f"{spec!r}")
        axes.append((name, n))
    if not axes:
        raise ValueError(f"mesh spec names no axes: {spec!r}")
    names = [n for n, _ in axes]
    if len(set(names)) != len(names):
        raise ValueError(f"mesh spec repeats an axis name: {spec!r}")
    return MeshConfig(tuple(axes),
                      tuple(devices) if devices is not None else None)


def mesh_spec_str(mesh: Mesh) -> str:
    """The ``name=size`` spec string of a built mesh."""
    return ",".join(f"{name}={size}" for name, size in mesh.shape.items())


def create_mesh(n_devices: Optional[int] = None, axis_name: str = STOCK_AXIS,
                devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over (up to) all devices: the process group's ranks by
    default."""
    devices = (list(devices) if devices is not None
               else list(range(world_size())))
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"create_mesh: requested {n_devices} devices, "
                             f"have {len(devices)}")
        devices = devices[:n_devices]
    return MeshConfig(((axis_name, len(devices)),), tuple(devices)).build()


def create_2d_mesh(n_batch: int, n_stocks: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   batch_axis: str = BATCH_AXIS) -> Mesh:
    """(member-ish, 'stocks') mesh: ensemble/sweep members × panel shards."""
    devices = (list(devices) if devices is not None
               else list(range(world_size())))
    total = len(devices)
    if n_stocks is None:
        n_stocks = total // max(n_batch, 1)
    if n_batch < 1 or n_stocks < 1 or n_batch * n_stocks > total:
        raise ValueError(
            f"mesh {n_batch}x{n_stocks} needs "
            f"{max(n_batch, 1) * max(n_stocks, 1)} devices, have {total}")
    return MeshConfig(((batch_axis, n_batch), (STOCK_AXIS, n_stocks)),
                      tuple(devices)).build()


def device_mesh(device=None, axis_name: str = STOCK_AXIS) -> Mesh:
    """The degenerate 1-device mesh (this process's rank by default):
    single-device placement in the same vocabulary as every other mesh."""
    return MeshConfig(((axis_name, 1),),
                      (rank() if device is None else device,)).build()


def slice_devices(slice_index: int, n_slices: int,
                  width: Optional[int] = None,
                  devices: Optional[Sequence] = None) -> Tuple[Any, ...]:
    """Device slice ``slice_index`` of ``n_slices`` disjoint contiguous
    slices of `devices` (the process group's ranks by default): the
    contract device-slice leases and worker meshes share, so two workers
    holding different slices never touch the same device."""
    devices = (list(devices) if devices is not None
               else list(range(world_size())))
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1: {n_slices}")
    if not 0 <= slice_index < n_slices:
        raise ValueError(f"slice_index {slice_index} not in [0, {n_slices})")
    w = width if width is not None else len(devices) // n_slices
    if w < 1 or n_slices * w > len(devices):
        raise ValueError(
            f"{n_slices} slices of width {w} exceed {len(devices)} devices")
    return tuple(devices[slice_index * w:(slice_index + 1) * w])


def grid_slice_mesh(slice_index: int = 0, n_slices: int = 1,
                    width: Optional[int] = None,
                    devices: Optional[Sequence] = None) -> Mesh:
    """1-D ('grid',) mesh over one device slice: the mesh a leased sweep
    worker lays its (lr × seed) bucket grid over."""
    devs = slice_devices(slice_index, n_slices, width, devices)
    return MeshConfig(((GRID_AXIS, len(devs)),), devs).build()


# -- placements ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec over a mesh: which span of each dimension a mesh position
    owns (the port's counterpart of ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    def _parts(self, entry) -> Tuple[Tuple[str, ...], int]:
        axes = (() if entry is None else
                (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a not in self.mesh.shape:
                raise ValueError(f"spec {self.spec} names axis {a!r}, not "
                                 f"in the mesh's {tuple(self.mesh.shape)}")
        return axes, int(np.prod([self.mesh.shape[a] for a in axes],
                                 dtype=np.int64))

    def index(self, shape: Sequence[int], device) -> Tuple[slice, ...]:
        """The slices of an array of `shape` that `device` owns; a split
        dimension must divide evenly."""
        pos = self.mesh.position(device)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            axes, parts = self._parts(entry)
            if parts == 1:
                out.append(slice(None))
                continue
            if n % parts:
                raise ValueError(f"dimension {d} of size {n} not divisible "
                                 f"by {parts} shards ({entry!r})")
            k = 0
            for a in axes:  # row-major over the named axes
                k = k * self.mesh.shape[a] + pos[a]
            w = n // parts
            out.append(slice(k * w, (k + 1) * w))
        return tuple(out)

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[Any, Tuple[slice, ...]]:
        """{device: its slices} over every device of the mesh."""
        return {dev: self.index(shape, dev)
                for dev in self.mesh.devices.ravel().tolist()}


def named_sharding(mesh: Mesh, *spec) -> Sharding:
    """THE Sharding constructor: ``spec`` entries, or one PartitionSpec."""
    if len(spec) == 1 and isinstance(spec[0], PartitionSpec):
        return Sharding(mesh, spec[0])
    return Sharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> Sharding:
    """Fully replicated over the mesh (params, macro series, scalars)."""
    return named_sharding(mesh, P())


def device_sharding(device=None) -> Sharding:
    """Single-device placement as the degenerate 1-device mesh (this
    rank's by default), replicated."""
    return replicated(device_mesh(device))


def member_axis_name(mesh: Mesh) -> str:
    """Which of the stack axes ('members' / legacy 'batch' / 'grid') this
    mesh carries; raises when it has none."""
    for name in _STACK_AXES:
        if name in mesh.shape:
            return name
    raise ValueError(
        f"mesh axes {tuple(mesh.shape)} have no member-ish axis "
        f"(expected one of {_STACK_AXES})")


def member_sharding(mesh: Mesh, axis_name: Optional[str] = None) -> Sharding:
    """Leading-axis sharding of member-stacked trees over the stack axis."""
    return named_sharding(mesh, member_axis_name(mesh) if axis_name is None
                          else axis_name)


# -- regex partition rules -----------------------------------------------------

Rule = Tuple[str, PartitionSpec]


def _leaves(tree, path=()):
    """(path tuple, leaf) of a nested dict/list/tuple, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not isinstance(
            tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


def _rebuild(tree, values):
    """`tree`'s structure with its leaves replaced, in order, by `values`."""
    it = iter(values)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not isinstance(t, PartitionSpec):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _is_scalar(leaf) -> bool:
    shape = _shape(leaf)
    return len(shape) == 0 or int(np.prod(shape)) == 1


def match_partition_rules(rules: Sequence[Rule], tree) -> Any:
    """`tree` with each leaf replaced by its :class:`PartitionSpec`, by
    regex over the ``/``-joined leaf path.

    Scalars (0-d or single-element leaves) are replicated without
    consulting the rules; otherwise the FIRST rule whose pattern
    ``re.search``-matches the path wins (list order is the precedence). A
    leaf no rule matches raises ``ValueError`` naming the path: end a rule
    list with ``(".*", P())`` to replicate by default explicitly."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(path, leaf):
        if _is_scalar(leaf):
            return P()
        name = "/".join(path)
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return spec
        raise ValueError(
            f"no partition rule matched leaf {name!r} (shape "
            f"{_shape(leaf)}); add a rule or an explicit ('.*', P()) "
            "catch-all")

    return _rebuild(tree, [spec_for(p, leaf) for p, leaf in _leaves(tree)])


def _clip_spec(spec: PartitionSpec, leaf) -> PartitionSpec:
    """Drop trailing spec entries beyond the leaf's rank (a rank-2 rule may
    serve a rank-1 leaf of the same family, e.g. returns vs n_assets)."""
    ndim = len(_shape(leaf))
    entries = tuple(spec)
    if len(entries) <= ndim:
        return spec
    if any(e is not None for e in entries[ndim:]):
        raise ValueError(
            f"partition spec {entries} names a mesh axis beyond the leaf's "
            f"rank {ndim}")
    return P(*entries[:ndim])


def tree_shardings(mesh: Mesh, tree, rules: Sequence[Rule]) -> Any:
    """`tree` with each leaf replaced by its :class:`Sharding` over
    `mesh` under `rules`."""
    specs = match_partition_rules(rules, tree)
    pairs = zip((s for _, s in _leaves(specs)),
                (leaf for _, leaf in _leaves(tree)))
    return _rebuild(tree, [named_sharding(mesh, _clip_spec(s, leaf))
                           for s, leaf in pairs])


def _local(leaf, sharding: Sharding, device):
    """`device`'s part of one leaf, as its own contiguous tensor (a
    kernel refuses a strided view)."""
    import torch

    idx = sharding.index(_shape(leaf), device)
    if all(s == slice(None) for s in idx):
        return leaf
    part = leaf[idx]
    return (part.contiguous().clone() if isinstance(part, torch.Tensor)
            else np.ascontiguousarray(part))


def shard_tree(tree, mesh: Mesh, rules: Sequence[Rule], device=None):
    """This rank's (or `device`'s) part of every leaf under its
    rule-matched sharding; replicated leaves come back as they are."""
    device = rank() if device is None else device
    shardings = tree_shardings(mesh, tree, rules)
    pairs = zip((leaf for _, leaf in _leaves(tree)),
                (s for _, s in _leaves(shardings)))
    return _rebuild(tree, [_local(leaf, s, device) for leaf, s in pairs])


# -- canonical rule sets -------------------------------------------------------


def batch_rules(axis_name: str = STOCK_AXIS) -> Tuple[Rule, ...]:
    """The canonical panel-batch layout: stock axis sharded, time/feature
    axes and the macro series replicated; extra keys (n_assets, anything a
    caller threads through) replicate via the explicit catch-all."""
    return (
        (r"(^|/)individual_t$", P(None, None, axis_name)),
        (r"(^|/)individual$", P(None, axis_name, None)),
        (r"(^|/)(returns|mask)$", P(None, axis_name)),
        (r"(^|/)macro$", P()),
        (r".*", P()),
    )


def member_rules(axis_name: str = MEMBER_AXIS) -> Tuple[Rule, ...]:
    """Member/grid-stacked trees: every non-scalar leaf's LEADING axis maps
    onto the mesh's stack dimension."""
    return ((r".*", P(axis_name)),)


def grid_rules() -> Tuple[Rule, ...]:
    return member_rules(GRID_AXIS)


# the fixed key set of the canonical batch dict, for shardings-by-key
# consumers (the streamed sharded transfer indexes by key before any array
# exists to match rules against)
BATCH_KEYS = ("returns", "mask", "individual", "individual_t", "macro",
              "n_assets")
# the dimension of each batch key that carries the stocks
STOCK_DIMS = {"returns": 1, "mask": 1, "individual": 1, "individual_t": 2}


def batch_shardings(mesh: Mesh, axis_name: str = STOCK_AXIS,
                    keys: Sequence[str] = BATCH_KEYS) -> Dict[str, Sharding]:
    """Per-key :class:`Sharding` of the canonical batch: the rule set of
    :func:`batch_rules` evaluated against the key names alone."""
    compiled = [(re.compile(pat), spec)
                for pat, spec in batch_rules(axis_name)]

    def spec_for(name: str) -> PartitionSpec:
        for pat, spec in compiled:
            if pat.search(name) is not None:
                return spec
        raise ValueError(f"no batch partition rule matched key {name!r}")

    return {k: named_sharding(mesh, spec_for(k)) for k in keys}


def stock_span(n: int, mesh: Mesh, device=None,
               axis_name: str = STOCK_AXIS) -> Tuple[int, int]:
    """[a, b): `device`'s (this rank's by default) contiguous span of a
    stock axis of `n`, which the mesh's stock axis must divide."""
    parts = int(mesh.shape[axis_name])
    if n % parts:
        raise ValueError(f"stock axis {n} not divisible by mesh axis "
                         f"{parts}; pad with PanelDataset.pad_stocks()")
    sl = named_sharding(mesh, P(None, axis_name)).index(
        (1, n), rank() if device is None else device)[1]
    a, b, _ = sl.indices(n)
    return a, b


def shard_batch(batch, mesh: Mesh, axis_name: str = STOCK_AXIS, device=None):
    """This rank's (or `device`'s) local batch: each field's contiguous
    slice under its rule-matched stock-axis sharding, on the field's own
    device; replicated fields as they are. N must divide the mesh's stock
    axis (pad with ``PanelDataset.pad_stocks(mesh.shape[axis_name])``
    first). Beyond one shard the local batch carries ``n_assets``, the
    true global count (the batch's own, else its N)."""
    import torch

    sh = batch_shardings(mesh, axis_name)
    device = rank() if device is None else device
    out = {}
    n_global = None
    for k, v in batch.items():
        dim = STOCK_DIMS.get(k)
        if dim is not None:
            n = v.shape[dim]
            n_global = n if n_global is None else n_global
            if n % mesh.shape[axis_name] != 0:
                raise ValueError(
                    f"batch[{k!r}] stock axis {n} not divisible by mesh "
                    f"axis {mesh.shape[axis_name]}; pad with "
                    "PanelDataset.pad_stocks()")
        out[k] = _local(v, sh.get(k) or replicated(mesh), device)
    if int(mesh.shape[axis_name]) > 1 and "n_assets" not in out:
        ref = out.get("returns")
        n_assets = np.float32(n_global)
        out["n_assets"] = (torch.tensor(n_assets, device=ref.device)
                           if isinstance(ref, torch.Tensor) else n_assets)
    return out


# -- grid/member tree placement ------------------------------------------------


def stack_tree_shardings(mesh: Mesh, tree,
                         axis_name: Optional[str] = None) -> Any:
    """Leading-axis shardings of a member/grid-stacked tree with the naive
    fallback: a leaf whose leading dimension the mesh's stack axis does not
    divide is replicated instead (values never depend on divisibility, only
    the layout does). Scalars replicate."""
    axis = member_axis_name(mesh) if axis_name is None else axis_name
    size = int(mesh.shape[axis])

    def sh(leaf):
        shape = _shape(leaf)
        if len(shape) == 0 or shape[0] % size != 0:
            return replicated(mesh)
        return named_sharding(mesh, axis)

    return _rebuild(tree, [sh(leaf) for _, leaf in _leaves(tree)])


def shard_stack_tree(tree, mesh: Mesh, axis_name: Optional[str] = None,
                     device=None):
    """This rank's (or `device`'s) part of a member/grid-stacked tree under
    :func:`stack_tree_shardings`."""
    device = rank() if device is None else device
    shardings = stack_tree_shardings(mesh, tree, axis_name)
    pairs = zip((leaf for _, leaf in _leaves(tree)),
                (s for _, s in _leaves(shardings)))
    return _rebuild(tree, [_local(leaf, s, device) for leaf, s in pairs])
