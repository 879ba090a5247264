"""The counterpart of `jax.lax.cond` for the step's branches on a device
scalar: `cond(pred, true_fn, false_fn, *operands)` returns the taken side's
tree, and `when(pred, fn, *operands)` runs a branch that updates its
operands in place and whose other side is the identity.

`pred` is a bool tensor of shape () or (R,), one per robot.  Each call takes
one of three routes, chosen from `pred` alone:

  * "select": a `pred` of more than one element (a fleet: JAX's cond under
    `vmap` batches back to a select), or one on a card outside a CUDA graph
    capture (`DeviceProgram`'s eager first call).  Both sides of a `cond`
    run and `tree_select` keeps the taken one leaf by leaf; `when` calls
    `fn(*operands, when=pred)`.  Nothing is read to the host, and the
    eager call warms up both sides (and the conditional-node runtime
    below) before the capture.
  * "branch": a CPU `pred` of one element.  `bool(pred)` picks the side, as
    JAX does on the CPU; only the taken side runs.
  * "graph": a CUDA `pred` of one element while its stream is captured.
    Each side is captured into the body of a CUDA-graph IF node
    (csrc/graph_cond.cu), so a replay runs only the taken one.  `cond`
    captures `true_fn` under `pred` and `false_fn` under `~pred`; the
    false body copies its outputs into the true body's, so what follows
    reads one fixed set of tensors whichever side ran.  A true-side leaf
    that existed before its body (an operand returned as it is) is never
    written by the other body: the merged leaf is then the false side's
    (its own copy if it, too, is an older tensor), and a third IF node on
    `pred` copies the true side's leaf into it.  `when` is one IF node with
    no other side, since a tensor made inside a body holds stale values on
    every replay that skips it.

A `when` body has one form for every route: `fn(*operands, when=None)`
on the branch and graph routes (the branch is taken), `fn(*operands,
when=mask)` on the select route.  It writes every leaf it changes into the
operands' own tensors, where the () or (R,) mask is True (`assign`,
`clear`), and returns them; `when` checks that on all three routes.

There is no fallback: a capture that cannot make its IF nodes raises
`BranchError`, naming the branch, and never turns into a select.

Each `cond` or `when` that takes the select route counts `control.selects`
(utils/observability.py `TRACER`): the masked bodies a frame runs whatever
its predicate.  A captured graph holds its selects, and `DeviceProgram`
counts them again on each replay (utils/graph.py).

The bodies' allocations go to one private memory pool per device, shared by
every graph, as one `DeviceProgram`'s graphs share its pool: the graphs are
replayed one at a time.  `IF_NODES` lists every IF node captured, with the
kernel, copy and fill nodes of its body, so a trace can be held against
what each taken branch adds (chip_smoke.py phase 13).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from gem_tpu_torch.utils.observability import TRACER
from gem_tpu_torch.utils.tree import (lead, tree_leaves, tree_map,
                                      tree_select)


class BranchError(RuntimeError):
    """A branch could not be captured as conditional nodes."""


# (branch name, kernel + copy + fill nodes of its body) per IF node captured
IF_NODES: list[tuple[str, int]] = []


def route(pred) -> str:
    """"select", "branch" or "graph" (see the module docstring)."""
    if pred.numel() != 1:
        return "select"
    if pred.device.type != "cuda":
        return "branch"
    if torch.cuda.is_current_stream_capturing():
        return "graph"
    return "select"


def _name(fn) -> str:
    return getattr(getattr(fn, "func", fn), "__name__", repr(fn))


def _identity(operands):
    return operands[0] if len(operands) == 1 else tuple(operands)


def cond(pred, true_fn, false_fn, *operands):
    """`true_fn(*operands)` where `pred`, else `false_fn(*operands)`.  The
    sides must return trees of one structure, shapes and dtypes, and must
    not write into their operands (on the select route both run on
    them)."""
    kind = route(pred)
    if kind == "branch":
        return (true_fn if bool(pred) else false_fn)(*operands)
    if kind == "select":
        TRACER.count("control.selects")
        _warm_up(pred)
        return tree_select(pred, true_fn(*operands), false_fn(*operands))
    name = f"cond({_name(true_fn)}, {_name(false_fn)})"
    try:
        return _graph_cond(pred, true_fn, false_fn, operands)
    except Exception as e:
        raise BranchError(f"{name} under CUDA graph capture: {e}") from e


def when(pred, fn, *operands):
    """`fn(*operands)` where `pred`, else the operands as they are.  `fn`
    updates its operands in place and returns them; on the select route
    it is called with `when=pred` and writes only where that is True (see
    the module docstring)."""
    kind = route(pred)
    if kind == "select":
        TRACER.count("control.selects")
        _warm_up(pred)
        return _in_place(fn, fn(*operands, when=pred), operands)
    if kind == "branch":
        if not bool(pred):
            return _identity(operands)
        return _in_place(fn, fn(*operands), operands)
    name = f"when({_name(fn)})"
    try:
        with _if_node(pred, False, _name(fn)):
            out = fn(*operands)
        return _in_place(fn, out, operands)
    except Exception as e:
        raise BranchError(f"{name} under CUDA graph capture: {e}") from e


def select(when, new, old):
    """`new` where a `when` body writes (everywhere for `when` None), else
    `old`; a () or (R,) `when` broadcasts over the trailing dims."""
    return new if when is None else tree_select(when, new, old)


def assign(when, leaf, new):
    """A `when` body's write of `new` into its operand `leaf`."""
    return leaf.copy_(select(when, new, leaf))


def clear(when, leaf):
    """A `when` body's zeroing of its operand `leaf`."""
    return leaf.zero_() if when is None \
        else leaf.masked_fill_(lead(when, leaf), 0)


def _warm_up(pred) -> None:
    """Before a single robot's capture: the body stream and pool."""
    if pred.device.type == "cuda" and pred.numel() == 1:
        _runtime(pred.device)


def _in_place(fn, out, operands):
    """`out`, after checking that every leaf is the operand's tensor at the
    same place."""
    got, want = tree_leaves(out), tree_leaves(_identity(operands))
    if list(got) != list(want) or any(
            g.data_ptr() != w.data_ptr() or g.shape != w.shape
            for g, w in zip(got.values(), want.values())):
        bad = [k for k in want if k not in got
               or got[k].data_ptr() != want[k].data_ptr()]
        raise BranchError(f"when({_name(fn)}) must update its operands in "
                          f"place and return them; new tensors at {bad}")
    return out


# ---------------------------------------------------------------------------
# The graph route


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class _Fresh(TorchDispatchMode):
    """Records the storages that the operators run under it create: an
    output whose storage is none of its inputs'."""

    def __init__(self):
        super().__init__()
        self.storages = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = set(map(_storage, _tensors((args, kwargs))))
        self.storages.update(s for s in map(_storage, _tensors(out))
                             if s not in seen)
        return out


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _graph_cond(pred, true_fn, false_fn, operands):
    true_made, false_made = _Fresh(), _Fresh()
    with _if_node(pred, False, _name(true_fn)), true_made:
        t = true_fn(*operands)
    fixups = []

    def merge(x, y):
        if x is y:
            return x
        if x.shape != y.shape or x.dtype != y.dtype:
            raise BranchError(f"cond sides differ: {x.dtype} "
                              f"{tuple(x.shape)} and {y.dtype} "
                              f"{tuple(y.shape)}")
        if _storage(x) in true_made.storages:
            x.copy_(y)
            return x
        if _storage(y) not in false_made.storages:
            y = y.clone()
        fixups.append((y, x))
        return y

    with _if_node(pred, True, _name(false_fn)), false_made:
        merged = tree_map(merge, t, false_fn(*operands))
    if fixups:
        with _if_node(pred, False, f"{_name(true_fn)} (merge)"):
            for dst, src in fixups:
                dst.copy_(src)
    return merged


def _begin_if_node(stream: int, pred: int, negate: bool, body: int) -> None:
    """Add an IF node on the device bool at `pred` to the graph that
    `stream` captures and start capturing `body` into its body."""
    err = _runtime_lib().gem_graph_if_begin(stream, pred, int(negate), body)
    if err != 0:
        raise BranchError(f"gem_graph_if_begin: CUDA error {err}")


@contextlib.contextmanager
def _if_node(pred, negate: bool, name: str):
    """Capture the block into the body of an IF node on `pred` (on `~pred`
    with `negate`), on the body stream, allocating from the body pool; log
    it in `IF_NODES` as `name`."""
    dev = pred.device
    body, pool = _runtime(dev)
    stream = torch.cuda.current_stream(dev)
    if stream.cuda_stream == body.cuda_stream:
        raise BranchError("a branch inside a branch's body is not captured")
    if pred.dtype != torch.bool or not pred.is_contiguous():
        raise BranchError(f"{name}: the predicate must be a contiguous bool "
                          f"tensor, not {pred.dtype}")
    _begin_if_node(stream.cuda_stream, pred.data_ptr(), negate,
                   body.cuda_stream)
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
    work = ctypes.c_longlong()
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
        err = _runtime_lib().gem_graph_if_end(body.cuda_stream,
                                              ctypes.byref(work))
    if err != 0:
        raise BranchError(f"gem_graph_if_end: CUDA error {err}")
    IF_NODES.append((name, work.value))


def _runtime_lib():
    from gem_tpu_torch.kernels._build import library

    return library()


@functools.lru_cache(maxsize=None)
def _runtime_on(index: int):
    lib = _runtime_lib()
    handle = ctypes.c_void_p()
    err = lib.gem_graph_stream_create(ctypes.byref(handle))
    if err != 0:
        raise BranchError(f"gem_graph_stream_create: CUDA error {err}")
    dev = torch.device("cuda", index)
    return (torch.cuda.ExternalStream(handle.value, device=dev),
            torch.cuda.graph_pool_handle())


def _runtime(dev):
    """(body stream, body pool) of a card, made outside any capture by the
    first select on it."""
    if not hasattr(torch._C, "_cuda_beginAllocateCurrentThreadToPool"):
        raise BranchError("this torch cannot route allocations into a "
                          "graph pool (_cuda_beginAllocateCurrentThreadToPool)")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return _runtime_on(index)


def count_graph_nodes(graph) -> tuple[int, int, int]:
    """(nodes, conditional nodes, kernel + copy + fill nodes) at the top
    level of a captured `torch.cuda.CUDAGraph(keep_graph=True)`."""
    counts = [ctypes.c_longlong() for _ in range(3)]
    err = _runtime_lib().gem_graph_count_nodes(
        graph.raw_cuda_graph(), *map(ctypes.byref, counts))
    if err != 0:
        raise BranchError(f"gem_graph_count_nodes: CUDA error {err}")
    return tuple(c.value for c in counts)
