"""The counterpart of `jax.jit` for the package's fixed-shape state
transforms, `fn(state, inputs) -> (state, outputs)`: CUDA graphs.

`DeviceProgram` holds a state at fixed addresses (its buffers) and runs
such functions over it.  On the card each (function, input structure)
pair is captured once into a `torch.cuda.CUDAGraph` and replayed after:

  * the inputs are copied into static input buffers before each replay,
    one `torch._foreach_copy_` per dtype (a frame's dozen leaves in three
    calls: the host's work before a replay is on a closed loop's critical
    path); a frame with or without an optional leaf (`loop_closure`,
    `image`) is another structure and another graph, as in a JAX retrace;
  * inside the captured region, every state leaf that the function
    replaces instead of updating in place is copied back into its buffer
    (`write_back`), so the state stays at its addresses across replays;
  * the outputs are copied out of the graph's own tensors after a replay,
    on the device and without a sync, so an output that the caller keeps
    across a later call keeps its values, as a fresh JAX array does.

The first call of each pair runs the function eagerly on the state, and
that run is the call's own result; then the pair is captured.  The eager
run is the warm-up a capture needs: it builds the kernel library, fills the
cached device tables and initialises the libraries, none of which may
happen while a stream is captured.  Its branches (utils/control.py `cond`,
`when`) take the select route, so both sides of each are warmed up; in the
capture a single robot's branches become CUDA-graph IF nodes, which `cond`
finds on the capturing stream itself, and `write_back` runs after them, on
the merged outputs.  So each frame launches each kernel once on the
device, the first one included.  A capture that fails raises, naming the
branch that broke when a branch did, after the eager run has advanced the
state; no graph is kept (the failed one is destroyed at once), so the
next call tries again.  There is no eager fallback.  All graphs of one
program share one memory pool, and they are replayed one at a time.

On CPU tensors the function is called directly, as JAX on the CPU runs the
same function.

Each call is one unit of the tracer (utils/observability.py): spans
`gem.program.copy_in`, `gem.program.replay` and `gem.program.copy_out`
(on the CPU the call itself is the replay and the copy spans are empty),
`gem.program.capture` around a first call's eager run and capture; counters
`program.replays`, `program.captures` and `program.graphs_dropped`,
`program.bytes_in` on each replay (the bytes copied into the graph's static
inputs: the input leaves' `nbytes`, summed once at capture; nothing on the
CPU, which copies nothing), and on each replay what the function counted
while it was captured (a fleet's `control.selects`), so a replay counts
what an eager call does; stamps
`program.in` before the input copies, `write_back` before the write-back
and `program.out` after the output copies.  The graphs hold the stamps
exactly while the tracer is on: turning it on or off drops them, to be
captured again.
"""

from __future__ import annotations

import torch

from gem_tpu_torch.utils.control import BranchError
from gem_tpu_torch.utils.observability import TRACER
from gem_tpu_torch.utils.tree import tree_leaves, tree_map


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def write_back(dst, src) -> None:
    """Copy every leaf of `src` into the leaf of `dst` at the same place,
    unless it already is that tensor (updated in place).  A leaf of `src`
    that shares memory with a leaf about to be written is copied out first,
    so no copy reads what another one overwrote."""
    got = tree_leaves(src)
    moves = []
    for key, d in tree_leaves(dst).items():
        s = got[key]
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"write_back: {key} is {s.dtype} "
                             f"{tuple(s.shape)}, its buffer {d.dtype} "
                             f"{tuple(d.shape)}")
        if s.data_ptr() != d.data_ptr():
            moves.append((d, s))
    written = {_storage(d) for d, _ in moves}
    moves = [(d, s.clone() if _storage(s) in written else s)
             for d, s in moves]
    for d, s in moves:
        d.copy_(s)


def _signature(leaves: dict) -> tuple:
    return tuple((k, tuple(t.shape), t.dtype, t.device)
                 for k, t in leaves.items())


def _copy_groups(static_in: list) -> list:
    """[(buffers, positions)]: the static inputs of each dtype and their
    positions among the input leaves, for one `_foreach_copy_` a dtype."""
    groups = {}
    for i, t in enumerate(static_in):
        dst, at = groups.setdefault(t.dtype, ([], []))
        dst.append(t)
        at.append(i)
    return list(groups.values())


def _fresh(t):
    return t.clone(memory_format=torch.contiguous_format)


class DeviceProgram:
    """A state at fixed addresses and the CUDA graphs that advance it.

    `program(fn, inputs)` runs `fn(program.state, inputs)`, keeps the new
    state and returns the outputs.  `program.state` is the live state: the
    next call overwrites it in place, so copy it (`state_to_numpy`) to keep
    a snapshot.  Assigning a state copies it into the buffers when its
    leaves have the buffers' shapes and types, and otherwise takes a copy
    of it as new buffers and drops every graph, to be captured again."""

    def __init__(self, state):
        self._buffers = None
        self._graphs = {}
        self._stamped = False        # the graphs hold the tracer's stamps
        self._pool = None
        self.state = state

    @property
    def state(self):
        return self._buffers

    @state.setter
    def state(self, state) -> None:
        leaves = tree_leaves(state)
        self.device = next(iter(leaves.values())).device
        if self.device.type != "cuda":
            self._buffers = state
            self._drop_graphs()
        elif self._buffers is not None and _signature(leaves) \
                == _signature(tree_leaves(self._buffers)):
            write_back(self._buffers, state)
        else:
            self._drop_graphs()
            self._buffers = tree_map(_fresh, state)

    def _drop_graphs(self) -> None:
        if self._graphs:
            TRACER.count("program.graphs_dropped", len(self._graphs))
        self._graphs.clear()

    def __call__(self, fn, inputs):
        with TRACER.unit():
            return self._call(fn, inputs)

    def _call(self, fn, inputs):
        dev = self.device
        if dev.type != "cuda":
            TRACER.mark("program.in", dev)
            with TRACER.span("gem.program.copy_in"):
                pass
            with TRACER.span("gem.program.replay"):
                self._buffers, out = fn(self._buffers, inputs)
            TRACER.mark("write_back", dev)
            with TRACER.span("gem.program.copy_out"):
                pass
            TRACER.mark("program.out", dev)
            return out
        leaves = tree_leaves(inputs)
        if TRACER.on != self._stamped:
            self._drop_graphs()
            self._stamped = TRACER.on
        key = (fn, _signature(leaves))
        entry = self._graphs.get(key)
        if entry is None:
            for name, t in leaves.items():
                if t.device != dev:
                    raise ValueError(f"DeviceProgram: input {name} is on "
                                     f"{t.device}, the state on {dev}")
            with TRACER.span("gem.program.capture"):
                return self._run_and_capture(fn, inputs, key)
        graph, copies, static_out, counted, nbytes = entry
        TRACER.mark("program.in", dev)
        with TRACER.span("gem.program.copy_in"):
            src = list(leaves.values())
            for dst, at in copies:
                torch._foreach_copy_(dst, [src[i] for i in at])
        TRACER.count("program.bytes_in", nbytes)
        with TRACER.span("gem.program.replay"):
            graph.replay()
        TRACER.count("program.replays")
        for name, n in counted.items():
            TRACER.count(name, n)
        with TRACER.span("gem.program.copy_out"):
            out = tree_map(torch.clone, static_out)
        TRACER.mark("program.out", dev)
        return out

    def _run_and_capture(self, fn, inputs, key):
        TRACER.mark("program.in", self.device)
        static_in = tree_map(_fresh, inputs)
        new_state, out = fn(self._buffers, static_in)
        TRACER.mark("write_back", self.device)
        out = tree_map(torch.clone, out)
        write_back(self._buffers, new_state)
        TRACER.mark("program.out", self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        buffers = {_storage(t) for t in tree_leaves(self._buffers).values()}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool), \
                    TRACER.tally() as counted:
                new_state, static_out = fn(self._buffers, static_in)
                TRACER.mark("write_back", self.device)
                # an output that is a state buffer would be read after the
                # write-back below: copy it out first
                static_out = tree_map(
                    lambda t: t.clone() if _storage(t) in buffers else t,
                    static_out)
                write_back(self._buffers, new_state)
        except RuntimeError as e:
            # destroy the half-made graph now: the exception's frames hold
            # it, and a collection that destroys it during a later capture
            # invalidates that capture (or crashes one with IF nodes)
            graph.reset()
            # and capture the next graph into a fresh pool: the tensors the
            # failed capture made there live on in those frames, so the
            # allocator keeps the pool, with no user if this graph was its
            # only one, and a capture into such a pool fails an assertion
            self._pool = None
            name = getattr(fn, "func", fn).__name__
            # a failed IF node may surface as the capture's end failing
            cause = e
            while cause is not None and not isinstance(cause, BranchError):
                cause = cause.__context__
            raise RuntimeError(f"DeviceProgram: CUDA graph capture of "
                               f"{name} failed: {cause or e}") from e
        static_in = list(tree_leaves(static_in).values())
        self._graphs[key] = (graph, _copy_groups(static_in), static_out,
                             counted, sum(t.nbytes for t in static_in))
        TRACER.count("program.captures")
        return out
