"""Warm start: a step captured as a CUDA graph before frame 0 (port of
``runtime/aot.py``).

The JAX package's ``get_or_compile`` hands an app its step compiled ahead
of the first frame and specialised to the argument shapes, so the first
frame pays no compile.  The port has no compiler in the loop; its cold
costs are the ``nvcc`` build of the kernels (kept by ``runtime/cache.py``),
the first launches (libraries loaded, K7's neighbourhood offsets copied to
the card, the allocator filled) and, every frame, the host's dispatch of
some 2,000 launches.  :func:`get_or_compile` pays the first two before
frame 0 and captures one call of the step in a ``torch.cuda.CUDAGraph``,
which replays those launches without the host dispatching them.

Contract, as in JAX: the callable takes exactly ``example_args``'s
structure, with every tensor of the example's shape, dtype and device;
anything else in the structure (a host int, a config) is baked into the
graph and must equal the example's.  A host value that chooses a branch
(the local-map refresh of ``combined_image_step``) is therefore part of
the graph: capture one graph a branch pattern, each under its own
``extra``.

Outputs: each call copies its tensors into the graph's input buffers,
replays, and returns clones of the graph's outputs, so a tensor returned
by one call is never written by the next (a caller may keep poses across
calls) and the state a caller passes back aliases no graph buffer.  The
copies cost two passes over the state a frame (on a 2^20-slot map, ~35 MB
read and written each way).

With the span recorder armed (``runtime/tracer``) a capture also takes
the step's device spans as event nodes, and each call records the host
span ``aot.replay`` and the device spans ``aot.copy_in``, ``aot.graph`` and
``aot.clone_out``; such a graph has a tag of its own.  While the recorder
is off the graph and each call are what they are without it.

Graphs live in an in-process registry keyed by :func:`_tag`; a CUDA graph
cannot outlive its process, so nothing is written to disk: with ``save``,
``directory`` names the kernels' library directory (``runtime/cache.py``,
taking effect before the first build), the one artefact that persists.
There is no counterpart of JAX's serialised executable.  On a CPU device,
which the caller has to ask for, there is no graph: ``fn`` is returned
after one warm call.  A capture that fails raises; nothing falls back to
the eager step.

Any step the JAX ``get_or_compile`` takes is captured: the odometry and
combined steps, chained or not, ``batch_image_step`` (K4 is the
``knn_coords`` library's second entry point) and the sharded steps of
``parallel/``, whose kernel list (``device_io.path_kernels(...,
sharded=True)``: K5 in place of K3) the caller passes.  A sharded step's
collectives are captured with it: its process group and communicators must
exist before the capture (the first collective of a group creates its
communicator, which synchronises), and the warm calls have ended, on the
host too, before the capture begins, so no work of theirs is in flight
while the stream is captured.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from liodom_tpu_torch.runtime import cache, tracer

_GRAPHS: Dict[str, Callable[..., Any]] = {}
_LOCK = threading.Lock()
WARM_CALLS = 2              # eager calls on a side stream before a capture


def _device(leaves) -> torch.device:
    """The one device of the tensor leaves; raises for none or several."""
    devs = {x.device for x in leaves if isinstance(x, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"get_or_compile: example tensors on {devs or 'no'} "
                         "device(s); they must share one")
    return devs.pop()


def _tag(name: str, example_args, extra: str = "") -> str:
    """Identity of a compiled step: ``name``, the torch version, the device
    kind, every leaf's shape and dtype (a non-tensor leaf's value, which the
    graph bakes in), and ``extra``, which must carry whatever changes the
    step without changing a shape (the configs, a branch pattern), and
    whether the span recorder is armed (its graph holds event nodes)."""
    leaves, _ = tree_flatten(example_args)
    dev = _device(leaves)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    sig = ";".join(f"{tuple(x.shape)}/{x.dtype}"
                   if isinstance(x, torch.Tensor)
                   else f"()/{type(x).__name__}={x!r}" for x in leaves)
    h = hashlib.sha256(f"{name}|{torch.__version__}|{kind}|{sig}|{extra}"
                       .encode() + (b"|spans" if tracer.RECORDER.on
                                    else b"")).hexdigest()[:16]
    return f"{name}-{h}"


def capture_graph(call: Callable[[], Any], dev: torch.device
                  ) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """``call()`` run :data:`WARM_CALLS` times on a side stream (libraries
    loaded, workspaces made), then captured once: (the graph, the outputs
    of the captured call, which each replay rewrites)."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARM_CALLS):
                call()
        torch.cuda.current_stream().wait_stream(side)
        # the warm calls end before the capture begins: a collective's work
        # is then no longer in flight (its communicator exists, and nothing
        # of it is left for the process group to track while capturing)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
    return graph, out


def _capture(fn: Callable, leaves, spec, dev: torch.device,
             kernel_names: Sequence[str]) -> Callable[..., Any]:
    """Build and load the named kernels, capture one call of ``fn`` on
    static copies of the leaves and return its replaying callable."""
    from liodom_tpu_torch.runtime.device_io import prepare_kernels
    prepare_kernels(kernel_names, dev)
    is_t = [isinstance(x, torch.Tensor) for x in leaves]
    static = [x.detach().clone() if t else x for x, t in zip(leaves, is_t)]
    graph, out = capture_graph(lambda: fn(*tree_unflatten(static, spec)),
                               dev)
    spans = tracer.RECORDER.take_captured()
    out_leaves, out_spec = tree_flatten(out)
    span = tracer.span

    def replay(*args):
        got, got_spec = tree_flatten(args)
        if got_spec != spec:
            raise TypeError(f"captured step called with {got_spec}, "
                            f"captured with {spec}")
        with span("aot.replay"):
            with span("aot.copy_in", device=True):
                for x, s, t in zip(got, static, is_t):
                    if not t:
                        if x != s:
                            raise ValueError(f"captured step baked in {s!r}, "
                                             f"called with {x!r}")
                    elif (not isinstance(x, torch.Tensor)
                          or x.shape != s.shape or x.dtype != s.dtype
                          or x.device != s.device):
                        raise ValueError(
                            f"captured step takes {tuple(s.shape)} {s.dtype} "
                            f"on {s.device}, got "
                            f"{getattr(x, 'shape', type(x))}")
                    elif x is not s:
                        s.copy_(x)
            with span("aot.graph", device=True):
                graph.replay()
            tracer.RECORDER.replayed(spans)
            with span("aot.clone_out", device=True):
                return tree_unflatten([o.clone() if isinstance(o, torch.Tensor)
                                       else o for o in out_leaves], out_spec)

    return replay


def get_or_compile(name: str, fn: Callable, example_args,
                   directory: Optional[str] = None, save: bool = True,
                   extra: str = "",
                   kernel_names: Optional[Sequence[str]] = None
                   ) -> Callable[..., Any]:
    """The warm-start entry: a callable for ``fn`` at ``example_args``'s
    structure, from the registry when this tag was captured before in
    this process.  On CUDA the step's kernels are built (into
    ``directory`` if given, see the module docstring) and loaded:
    ``kernel_names``, by default those of the odometry and map steps
    (``device_io.path_kernels(True)``; a sharded step of ``parallel/``
    passes ``path_kernels(..., sharded=True)``); then ``fn`` runs
    :data:`WARM_CALLS` times on the example args on a side stream and one
    call is captured.  On the CPU ``fn`` itself after one warm call.
    Raises if the capture fails."""
    tag = _tag(name, example_args, extra)
    with _LOCK:
        hit = _GRAPHS.get(tag)
    if hit is not None:
        return hit
    if save and directory is not None:
        cache.enable_persistent_cache(directory)
    leaves, spec = tree_flatten(example_args)
    dev = _device(leaves)
    if dev.type == "cuda":
        if kernel_names is None:
            from liodom_tpu_torch.runtime.device_io import path_kernels
            kernel_names = path_kernels(True)
        compiled = _capture(fn, leaves, spec, dev, kernel_names)
    elif dev.type == "cpu":
        fn(*example_args)
        compiled = fn
    else:
        raise ValueError(f"get_or_compile: no route for device {dev}")
    with _LOCK:
        return _GRAPHS.setdefault(tag, compiled)
