"""Device meshes and the trace-time mesh context.

Counterpart of ``mxnet_tpu/parallel/mesh.py``. The JAX package's mesh is a
``jax.sharding.Mesh`` over devices that XLA partitions one program across.
The port's ``Mesh`` is a plain object: axis names, a shape, the
``Context``s laid out over it (an object array), and, when it spans
processes, the ``torch.distributed`` group and the number of processes.

Within one process every context of a mesh names one physical device:
distinct contexts on one device are distinct *logical* devices (the rule of
``module/executor_group.py``), so ``[cpu(i) for i in range(8)]`` is one
CPU and ``[gpu(0)]`` one card. ``parallel/trainer.py`` runs the global batch
there as one program, which computes the function JAX's sharded step does.
Across processes each rank holds one context of the mesh's data axis, or
of its seq axis (ring attention across ranks, ``ring_attention.py``).

``trace_mesh``/``current_trace_mesh`` let a mesh-aware op find the mesh of
the step being run, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import contextvars

import numpy as np

from ..base import MXNetError

__all__ = ["make_mesh", "local_mesh", "trace_mesh", "current_trace_mesh", "Mesh", "MeshSpec",
           "parse_mesh_spec"]


class Mesh:
    """A device mesh: ``axis_names``, ``shape`` (an ordered dict name ->
    size, as ``jax.sharding.Mesh.shape``), ``devices`` (an object array of
    ``Context``s of that shape), ``process_count`` (the processes the mesh
    spans) and ``group`` (their ``torch.distributed`` group, or None)."""

    def __init__(self, devices, axis_names, process_count=1, group=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.process_count = int(process_count)
        self.group = group

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s; %d process(es))" % (
            ",".join("%s=%d" % (n, s) for n, s in self.shape.items()), self.process_count)


# copied from mxnet_tpu/parallel/mesh.py (MeshSpec; backend-free)
class MeshSpec:
    """Device-free mesh description: axis names and sizes, nothing else.

    The static-analysis passes reason about a *planned* mesh (``dp=8,model=2``
    on a box that has no 16 devices). A ``MeshSpec`` carries exactly the two
    attributes ``ShardingRules`` and the lint passes read (``axis_names``,
    ``shape``), so the same rules object drives both the real trainer mesh
    and the abstract plan."""

    __slots__ = ("shape", "axis_names")

    def __init__(self, axes):
        """``axes``: dict name -> size (ordering is axis order), or an
        iterable of (name, size) pairs."""
        self.shape = {str(k): int(v) for k, v in dict(axes).items()}
        if not self.shape:
            raise ValueError("MeshSpec needs at least one axis")
        for name, size in self.shape.items():
            if size < 1:
                raise ValueError("mesh axis %r has size %d" % (name, size))
        self.axis_names = tuple(self.shape)

    @property
    def size(self):
        return int(np.prod(list(self.shape.values())))

    @classmethod
    def of(cls, mesh):
        """Coerce a real mesh (or another MeshSpec) to a MeshSpec."""
        if isinstance(mesh, cls):
            return mesh
        return cls({name: mesh.shape[name] for name in mesh.axis_names})

    def __repr__(self):
        return "MeshSpec(%s)" % ",".join(
            "%s=%d" % (n, s) for n, s in self.shape.items())


# copied from mxnet_tpu/parallel/mesh.py (parse_mesh_spec; backend-free)
def parse_mesh_spec(spec):
    """Parse ``"dp=8,model=2"`` (the graphlint ``--mesh`` syntax) into a
    ``MeshSpec``. Also accepts a dict or an existing MeshSpec/Mesh."""
    if isinstance(spec, str):
        axes = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    "--mesh expects AXIS=SIZE[,AXIS=SIZE...], got %r" % spec)
            name, size = part.split("=", 1)
            name = name.strip()
            if name in axes:
                # a typo'd 'dp=2,dp=8' must not silently lint a wrong mesh
                raise ValueError("mesh axis %r given twice in %r"
                                 % (name, spec))
            axes[name] = int(size)
        return MeshSpec(axes)
    if isinstance(spec, dict):
        return MeshSpec(spec)
    return MeshSpec.of(spec)


_TRACE_MESH = contextvars.ContextVar("mxtpu_torch_trace_mesh", default=None)


def current_trace_mesh():
    """The mesh of the SPMD step currently being run, or None."""
    return _TRACE_MESH.get()


@contextlib.contextmanager
def trace_mesh(mesh):
    tok = _TRACE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _TRACE_MESH.reset(tok)


def _default_devices(ctx=None):
    """``ctx`` (default: the current context), once for each process of the
    ``torch.distributed`` job (once outside one), and that process count."""
    from .. import dist
    from ..context import current_context

    world = dist.num_workers() if dist.is_initialized() else 1
    return [ctx or current_context()] * world, world


def _process_mesh(ctx):
    """The one-axis ``data`` mesh over every process of the job, each
    holding ``ctx`` (the mesh of a Module trained through a ``dist*``
    store)."""
    devices, world = _default_devices(ctx)
    return _mesh(devices, [world], ("data",), world)


def make_mesh(shape=None, axis_names=("data", "model"), devices=None):
    """Build a ``Mesh``.

    ``shape`` maps axis name → size (dict) or is a tuple aligned with
    ``axis_names``. Unspecified trailing axes default to size 1; a single
    ``-1`` entry absorbs the remaining devices. With no shape at all, every
    device lands on the first axis (pure data parallelism). ``devices`` are
    ``Context``s, all of this process; by default the current context,
    once for each process of a ``torch.distributed`` job, whose mesh then
    spans the processes."""
    process_count = 1
    if devices is None:
        devices, process_count = _default_devices()
    devices = list(devices)
    n = len(devices)
    if shape is None:
        sizes = [n] + [1] * (len(axis_names) - 1)
    elif isinstance(shape, dict):
        axis_names = tuple(shape.keys())
        sizes = list(shape.values())
    else:
        sizes = list(shape)
        if len(sizes) < len(axis_names):
            sizes += [1] * (len(axis_names) - len(sizes))
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError("mesh shape %s does not divide %d devices" % (sizes, n))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError("mesh shape %s != %d devices" % (sizes, n))
    return _mesh(devices, sizes, axis_names, process_count)


def _mesh(devices, sizes, axis_names, process_count):
    n = len(devices)
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    group = None
    if process_count > 1:
        # one axis over the ranks: the data axis (a rank's own rows), or a
        # seq axis (a rank's own block of positions: parallel/ring_attention.py)
        if tuple(axis_names)[0] not in ("data", "seq") or sizes[0] != n:
            raise MXNetError(
                "a mesh across %d processes holds one data axis (or one seq axis); a model "
                "axis across processes is ROADMAP.md section 1.4c (the JAX package's "
                "planner plans no multi-process job either)"
                % process_count)
        import torch.distributed as tdist

        group = tdist.group.WORLD
    return Mesh(dev_array.reshape(sizes), tuple(axis_names), process_count, group)


def local_mesh(n_devices=None, axis_names=("data",)):
    """Mesh over this process's first ``n_devices`` logical devices of the
    current context's type (``cpu(0)``, ``cpu(1)``, ...), the current
    context alone by default; one axis by default."""
    from ..context import Context, current_context

    ctx = current_context()
    devices = [ctx] if n_devices is None else [Context(ctx.device_type, i)
                                               for i in range(int(n_devices))]
    return make_mesh((len(devices),) + (1,) * (len(axis_names) - 1), axis_names, devices)
