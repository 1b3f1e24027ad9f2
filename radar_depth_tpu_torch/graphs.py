"""Per-shape CUDA graphs of the port's entry points: the counterpart of
``jax.jit``'s program cache.

The JAX package runs its served forward and its train step as one jitted
program per input shape (``radar_depth_tpu/inference.py``, ``train/loop.py``).
The port's counterpart on the card is a CUDA graph per key, captured once and
replayed: one call enqueues the whole forward or step, instead of one host
launch per kernel. ``ShapeGraphs`` owns the graphs of one callable:

* The key of a call is the structure of its arguments and the shapes, dtypes
  and devices of their tensors, the caller's own key (``model.training``),
  the optimizer's settings (the step's learning rate among them), the
  process's float32 and cuDNN flags, and the storage addresses of every
  parameter, buffer and optimizer state tensor the graph reads. A ``load_state_dict`` that copies in place keeps a graph;
  an optimizer's ``load_state_dict`` replaces its momentum buffers, so the
  next call captures anew instead of replaying stale pointers.
* Call 1 at a key runs eagerly: it builds the kernels, picks the cuDNN
  algorithms, fills the caches (``models/layers.py::_interp_matrix``) and
  creates the optimizer's momentum buffers. Call 2 copies its inputs into
  the graph's own (static) inputs, captures, and replays once to compute its
  result: the capture itself computes nothing, so a train step is applied
  once. Later calls copy their inputs in and replay.
* Each graph has its own memory pool, so graphs of different shapes never
  write each other's outputs. The caller's ``fresh`` turns the graph's
  static outputs into tensors that the next replay does not overwrite.
* A replay adds to each kernel's ``.launches`` counter (``ops/kernels.py::
  LAUNCH_COUNTERS``), to each kind of ``parallel/mesh.py::COLLECTIVES``
  (the halo exchanges' ``halo`` and ``halo_grad`` among them) and to
  ``parallel/spatial.py::HALO["bytes"]`` what the capture counted, so N
  replays count what N eager calls count; the capture's own counts are
  taken back, and so are the host seconds that its exchanges added to
  ``HALO["seconds"]`` (nothing moved then): those seconds come from eager
  calls only.
* A call runs eagerly, and touches no graph, when any module of the model has
  a forward or backward hook (a graph cannot replay Python), when a global
  module hook is set, inside ``disable_graphs()``, or when it draws from a
  generator that this torch cannot register with a graph.
* Over a process group (``mesh``) every rank must capture at the same call
  and replay at the same calls, or the collectives inside the graphs do not
  pair up. So there the key holds only what every rank shares (structure,
  shapes, the caller's key, the optimizer's settings, the flags) and the
  count of calls at it decides; the storage addresses, which one rank alone
  may see change (an allocator hands back the freed address on one rank and
  not on another), are checked instead, and a graph whose state moved
  raises rather than replay stale pointers.

Nothing catches a failed capture or replay: it raises. The entry points
capture only on the card, with the kernels (not ``plain=True``), and without
a process group or over an NCCL one, with or without a space axis
(``wanted``); the CPU and a gloo group run the eager path, which is also the
reference that a graph is held against.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from collections import OrderedDict, namedtuple
from typing import Callable, Iterable, Sequence

import torch

from radar_depth_tpu_torch.parallel.mesh import COLLECTIVES, is_distributed
from radar_depth_tpu_torch.parallel.spatial import HALO

_DISABLED = [0]
# the device types whose entry points capture; the CPU runs eagerly
CAPTURE_DEVICES = ("cuda",)


@contextlib.contextmanager
def disable_graphs():
    """Run every entry point eagerly inside (the counterpart of
    ``jax.disable_jit``): for a reference run in the same process, or for
    code patched in Python, which a captured graph would not see."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def wanted(device: torch.device, plain: bool = False, mesh=None) -> bool:
    """Whether an entry point on ``device`` captures: on the card, with the
    kernels, and either without a process group or over an NCCL one (data,
    replica x data, or data x space), whose collectives (the gradient and
    statistics all-reduces, a spatial mesh's halo exchanges and gathers) run
    on the card's streams and are captured with the step. Each of the
    mesh's communicators is made by the eager first call at a key, before
    any capture. A gloo group stays eager: its collectives run on the host,
    which a graph cannot hold."""
    if torch.device(device).type not in CAPTURE_DEVICES or plain:
        return False
    return not is_distributed(mesh) or mesh.backend == "nccl"


def can_register_generators() -> bool:
    """Whether this torch lets a graph draw from a ``torch.Generator`` of
    the caller's (``CUDAGraph.register_generator_state``)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


class CudaCapture:
    """The capture: ``CUDAGraph.capture_begin`` / ``capture_end`` on a side
    stream that waits for the current one, with a private memory pool for
    each graph. Unlike ``torch.cuda.graph`` it does not synchronise the
    card, and it empties the allocator's cache only when the free memory
    could not hold the graph's pool beside it (the pool needs about what
    the eager call just freed into the cache): a capture in a serving
    process (the daemon's first requests at a tile) then costs little more
    than the eager call, and a batch that fits eagerly still captures."""

    supports_generators = staticmethod(can_register_generators)

    def __init__(self):
        self._streams: dict = {}

    def __call__(self, fn: Callable, generators: Sequence = ()):
        """(graph, outputs): ``fn()`` captured; ``graph.replay()`` runs it
        on the current stream, writing ``outputs``."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        current = torch.cuda.current_stream()
        dev = current.device
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        side = self._streams[dev]
        side.wait_stream(current)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        if torch.cuda.mem_get_info(dev)[0] < cached:
            torch.cuda.empty_cache()
        # The garbage collector is paused: a destructor that it runs inside
        # the capture (a dropped graph's, held in a reference cycle) makes a
        # CUDA call that the capture forbids, and the capture fails.
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                # "thread_local": another thread's CUDA calls (the daemon's,
                # the autograd engine's) neither break nor join the capture
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    outputs = fn()
                finally:
                    graph.capture_end()
        finally:
            if enabled:
                gc.enable()
        current.wait_stream(side)
        return graph, outputs


def kernel_counters() -> list:
    """The kernels' wrappers whose ``.launches`` count their launches."""
    from radar_depth_tpu_torch.ops import kernels

    return [getattr(kernels, name) for name in kernels.LAUNCH_COUNTERS]


def _flatten(tree, leaves: list):
    """The structure of ``tree`` (dicts, lists, tuples; other leaves kept as
    constants), its tensors appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    return ("const", tree)


def _unflatten(spec, leaves: Iterable):
    if spec is None:
        return next(leaves)
    kind, items = spec
    if kind == "const":
        return items
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in items}
    return kind(_unflatten(v, leaves) for v in items)


def clone_tree(tree):
    """``tree`` (dicts, lists, tuples of tensors) with every tensor cloned:
    copies that no later replay overwrites."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    return _unflatten(spec, iter([t.clone() for t in leaves]))


def _flags() -> tuple:
    """The process-wide settings a capture bakes in: TF32 and cuDNN's
    algorithm choice."""
    b = torch.backends
    return (b.cudnn.enabled, b.cudnn.deterministic, b.cudnn.benchmark,
            b.cudnn.conv.fp32_precision, b.cuda.matmul.fp32_precision,
            torch.get_float32_matmul_precision())


def _global_hooks() -> bool:
    m = torch.nn.modules.module
    return any(getattr(m, name, None) for name in (
        "_global_forward_hooks", "_global_forward_pre_hooks",
        "_global_backward_hooks", "_global_backward_pre_hooks"))


# a captured graph, its static inputs and outputs, the launches per kernel
# counter, the collectives per kind and the halo bytes that one replay
# stands for
_Graph = namedtuple("_Graph",
                    "graph inputs outputs counts collectives halo_bytes")


class ShapeGraphs:
    """The graphs of ``fn`` (module docstring), at most ``max_graphs`` of
    them, the least recently used dropped first.

    ``fn(*args)`` takes trees (dicts, lists, tuples) of tensors and
    constants and returns a tree of tensors. ``model`` owns the state the
    graphs read: its tensors' addresses are part of the key (checked
    against it over a process group), and a hook on any of its modules (the
    tree as it is when this is built) sends the call to the eager path.
    ``fresh(outputs)`` maps a replay's static outputs to what the caller
    returns. ``lock`` is held over each call: a caller that reads more of a
    replay's static outputs than ``fresh`` copies holds it across the call
    and that read, so no other thread's replay rewrites them in between.
    ``mesh``: the one whose collectives ``fn`` issues, if any (a
    ``parallel.mesh.DataMesh``); with a process group the key is the ranks'
    shared one (module docstring). ``capture`` and ``counters`` are
    ``CudaCapture()`` and ``kernel_counters`` unless given (a test's
    stand-ins)."""

    def __init__(self, fn: Callable, model: torch.nn.Module,
                 fresh: Callable = lambda out: out, max_graphs: int = 16,
                 mesh=None, capture=None,
                 counters: Callable[[], list] | None = None):
        self.fn, self.fresh = fn, fresh
        self._modules = list(model.modules())  # the tree is fixed
        self.max_graphs = max_graphs
        self.shared = is_distributed(mesh)
        self.capture = CudaCapture() if capture is None else capture
        self.counters = kernel_counters if counters is None else counters
        # key -> [addresses, _Graph or None before the capture]
        self._graphs: OrderedDict = OrderedDict()
        self.lock = threading.RLock()  # one call at a time: static tensors
        self.stats = {"eager": 0, "captures": 0, "replays": 0}

    def release(self) -> None:
        """Drop every graph and its memory pool, and wait for the card. A
        graph that captured a process group's collectives holds the
        group's communicators: release it before the group is destroyed,
        or ``destroy_process_group`` waits on them (the ranks of a run on
        four cards hung at exit so). The next call at a key runs eagerly
        again."""
        with self.lock:
            self._graphs.clear()
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()

    def _scan(self, optimizer):
        """One pass over the model's modules: None if one has a hook, else
        the addresses of the tensors the graph reads besides its inputs and
        the optimizer's settings."""
        ptrs = []
        for mod in self._modules:
            if (mod._forward_hooks or mod._forward_pre_hooks
                    or mod._backward_hooks or mod._backward_pre_hooks):
                return None
            ptrs += [t.data_ptr() for t in mod._parameters.values()
                     if t is not None]
            ptrs += [t.data_ptr() for t in mod._buffers.values()
                     if t is not None]
        opt = ()
        if optimizer is not None:
            ptrs += [t.data_ptr() for s in optimizer.state.values()
                     for t in s.values() if isinstance(t, torch.Tensor)]
            opt = (id(optimizer), tuple(
                tuple(sorted((k, v) for k, v in g.items() if k != "params"))
                for g in optimizer.param_groups))
        return tuple(ptrs), opt

    def _key(self, spec, leaves, key, state) -> tuple:
        ptrs, opt = state
        return (spec, tuple((t.shape, t.dtype, t.device, t.stride())
                            for t in leaves), key, _flags(), opt,
                () if self.shared else ptrs)

    def __call__(self, *args, key: tuple = (), generators: Sequence = (),
                 optimizer: torch.optim.Optimizer | None = None):
        """``fn(*args)``, through the graph of the call's key. ``key``: the
        caller's part of it; ``generators``: the ``torch.Generator`` objects
        ``fn`` draws from, registered with its graph; ``optimizer``: the one
        whose state ``fn`` updates (its tensors' addresses join the key)."""
        with self.lock:
            out, replayed = self._call(args, key, generators, optimizer)
            return self.fresh(out) if replayed else out

    def _call(self, args, key, generators, optimizer):
        """(``fn(*args)``, False), or (a replay's static outputs, True)."""
        state = None
        if not (_DISABLED[0] or _global_hooks() or (
                generators and not self.capture.supports_generators())):
            state = self._scan(optimizer)
        if state is None:  # eager
            self.stats["eager"] += 1
            return self.fn(*args), False
        leaves: list = []
        spec = _flatten(args, leaves)
        k = self._key(spec, leaves, key, state)
        if k not in self._graphs:  # call 1: eager, then remembered
            out = self.fn(*args)
            self.stats["eager"] += 1
            # the key the next call sees: momentum buffers exist now
            state = self._scan(optimizer)
            k = self._key(spec, leaves, key, state)
            if k not in self._graphs:
                self._graphs[k] = [state[0], None]
                while len(self._graphs) > self.max_graphs:
                    self._graphs.popitem(last=False)
            return out, False
        ptrs, entry = self._graphs[k]
        self._graphs.move_to_end(k)
        if ptrs != state[0]:  # only a shared key lacks the addresses
            raise RuntimeError(
                "a parameter, buffer or optimizer state that a graph over a "
                "process group reads was replaced: the ranks cannot agree "
                "to capture anew on an address that one rank alone may see "
                "change, so build the step again after replacing its state")
        if entry is None:  # call 2: capture
            entry = self._capture(spec, leaves, generators)
            self._graphs[k][1] = entry
        else:
            for static, t in zip(entry.inputs, leaves):
                static.copy_(t)
        entry.graph.replay()
        for counter, n in zip(self.counters(), entry.counts):
            counter.launches += n
        COLLECTIVES.update(entry.collectives)
        HALO["bytes"] += entry.halo_bytes
        self.stats["replays"] += 1
        return entry.outputs, True

    def _capture(self, spec, leaves, generators) -> _Graph:
        inputs = [t.clone() for t in leaves]
        counters = self.counters()
        before = [c.launches for c in counters]
        kinds, halo = dict(COLLECTIVES), dict(HALO)
        graph, outputs = self.capture(
            lambda: self.fn(*_unflatten(spec, iter(inputs))), generators)
        counts = [c.launches - n for c, n in zip(counters, before)]
        for c, n in zip(counters, before):
            c.launches = n
        collectives = {k: n - kinds.get(k, 0) for k, n in COLLECTIVES.items()
                       if n != kinds.get(k, 0)}
        COLLECTIVES.clear()
        COLLECTIVES.update(kinds)
        halo_bytes = HALO["bytes"] - halo.get("bytes", 0)
        HALO.clear()
        HALO.update(halo)
        self.stats["captures"] += 1
        return _Graph(graph, inputs, outputs, counts, collectives,
                      halo_bytes)
