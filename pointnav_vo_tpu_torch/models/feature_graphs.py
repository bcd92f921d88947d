"""CUDA graphs for a policy's ``_features`` (``models/policy.py::_ActorCritic``),
and what the VO experts' graphs (``vo/ensemble.py::ExpertGraphs``) and the
VO frame features' (``vo/ensemble.py::frame_features_packed``) share with
them: the module tree a call reads (:class:`_Tree`), the rule that keeps a
call eager (:func:`eager_reason`), the capture (:func:`capture`) and, for
the features, the cache (:meth:`FeatureGraphs.call`).

One step of the policy's visual encoder is a thousand or so small kernels
(SE-ResNeXt101: 104 convs, 104 GroupNorms, 33 SE gates), whose launches
cost the host far more than their work costs the card.  Their shapes are
fixed for a given batch, and they take no host decision, so a graph
captured once replays them in one launch.

A call may replay only where :func:`eager_reason` finds nothing against it
(a CUDA input, gradients off, no whitening update, the single-step form,
no stream capture running, no forward hook on a module that ``_features``
runs), and only once its key has been met before: the first call of a key
runs eagerly, the second captures (torch's recipe: warm-up runs on a side
stream, then ``torch.cuda.graph`` into the cache's one memory pool per
card), and later ones copy the inputs into the graph's static buffers and
replay.  The key is every input's shape and dtype, the compute dtype, the
card, inference mode, and the address and dtype of every parameter and
buffer the modules hold: a replay reads the weights by address, so an
in-place write (``load_state_dict``, an optimizer step) is seen as it
happens, while ``.to()``, ``.half()`` or a new ``.data`` gives a new key.
A call reads the modules through a :class:`_Tree` kept from the call
before, which it rebuilds where a module, parameter or buffer was added,
replaced or removed: a walk of the SE-ResNeXt101 encoder's 594 modules
costs more host time than a replay.

The tracer counts ``policy_graph_eager`` (single-step calls run eagerly),
``policy_graph_captures`` and ``policy_graph_replays``.  What the tracer's
counters gained during the captured call (``se_gates``: 33 for
SE-ResNeXt101) they gain again on every replay, as an eager call would.
"""

from __future__ import annotations

import collections
import itertools
import operator
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.modules import module as _module

from pointnav_vo_tpu_torch.utils.logging import TRACER

SLOTS = 4  # graphs kept, and keys remembered as met once; the least recently used go first
WARMUP = 3  # eager runs on a side stream ahead of a capture

_values = dict.values
_chain = itertools.chain.from_iterable
_data_ptr = torch.Tensor.data_ptr
_dtype = operator.attrgetter("dtype")


class _Tree:
    """The modules under ``roots``, each once, with the lists a call reads:
    their forward hooks and pre-hooks, their parameters and buffers."""

    def __init__(self, roots: Sequence[nn.Module]):
        self.roots = list(roots)
        self.modules = list({id(m): m for r in self.roots for m in r.modules()}.values())
        self.hooks = ([m._forward_hooks for m in self.modules]
                      + [m._forward_pre_hooks for m in self.modules])
        dicts = [d for m in self.modules for d in (m._modules, m._parameters, m._buffers)]
        self.full = [d for d in dicts if d]
        self.empty = [d for d in dicts if not d]
        self.ids = list(map(id, _chain(map(_values, self.full))))
        self.tensors = [t for m in self.modules for d in (m._parameters, m._buffers)
                        for t in d.values() if t is not None]

    def current(self, roots: Sequence[nn.Module]) -> bool:
        """Whether the modules under ``roots`` hold the same submodules,
        parameters and buffers (by identity) as when this was built.  The
        tree keeps what it lists alive, so no id is reused meanwhile."""
        return (len(roots) == len(self.roots) and all(map(operator.is_, roots, self.roots))
                and not any(self.empty)
                and list(map(id, _chain(map(_values, self.full)))) == self.ids)

    def hooked(self) -> bool:
        return bool(_module._global_forward_hooks or _module._global_forward_pre_hooks
                    or any(self.hooks))

    def weights(self) -> tuple:
        """The address and then the dtype of every parameter and buffer."""
        return tuple(map(_data_ptr, self.tensors)) + tuple(map(_dtype, self.tensors))


def eager_reason(tree: _Tree, inputs: Sequence[torch.Tensor], seq: bool = False,
                 update_stats: bool = False) -> Optional[str]:
    """Why a call of ``tree``'s modules (a policy's ``_features``, the VO
    experts) on ``inputs`` must run eagerly (``"sequence"``,
    ``"update_stats"``, ``"grad"``, ``"hook"``, ``"device"`` or
    ``"capturing"``), or None where a graph may run it."""
    if seq:
        return "sequence"
    if update_stats:
        return "update_stats"
    if torch.is_grad_enabled():
        return "grad"
    if tree.hooked():
        return "hook"
    if any(t.device.type != "cuda" for t in inputs):
        return "device"
    if torch.cuda.is_current_stream_capturing():
        return "capturing"
    return None


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: List[torch.Tensor]  # the static tensors the graph reads
    output: Any  # what the captured call returned: a tensor, or a tuple of them
    counts: Dict[str, int]  # what the captured call added to the tracer's counters


class FeatureGraphs:
    """A policy's graphs of ``_features``, at most :data:`SLOTS` of them,
    and its :class:`_Tree`.  A copy or a pickle of the policy starts with
    none."""

    def __init__(self):
        self.graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self.seen: "collections.OrderedDict[tuple, None]" = collections.OrderedDict()
        self.pools: Dict[int, tuple] = {}  # card index -> the graphs' memory pool
        self._tree: Optional[_Tree] = None

    def __reduce__(self):
        return FeatureGraphs, ()

    def tree(self, roots: Sequence[nn.Module]) -> _Tree:
        if self._tree is None or not self._tree.current(roots):
            self._tree = _Tree(roots)
        return self._tree

    def sight(self, key) -> Tuple[str, Optional[_Graph]]:
        """``("eager", None)`` for a key met the first time, ``("capture",
        None)`` the second, ``("replay", graph)`` for one with a graph,
        which is then the most recently used."""
        g = self.graphs.get(key)
        if g is not None:
            self.graphs.move_to_end(key)
            return "replay", g
        if key in self.seen:
            del self.seen[key]
            return "capture", None
        self.seen[key] = None
        if len(self.seen) > SLOTS:
            self.seen.popitem(last=False)
        return "eager", None

    def keep(self, key, graph: _Graph) -> None:
        self.graphs[key] = graph
        if len(self.graphs) > SLOTS:
            self.graphs.popitem(last=False)

    def run(self, features: Callable[..., torch.Tensor], tree: _Tree,
            inputs: List[torch.Tensor], compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        """``features(*inputs)``, eagerly, by a capture or by a replay, for a
        call :func:`eager_reason` lets through."""
        dev = inputs[0].device
        key = (tuple((t.shape, t.dtype) for t in inputs), compute_dtype, dev.index,
               torch.is_inference_mode_enabled(), tree.weights())
        return self.call(features, key, inputs, "policy_graph")

    def call(self, fn: Callable[..., Any], key, inputs: List[torch.Tensor], counter: str):
        """``fn(*inputs)`` on the card: eagerly the first time ``key`` is met,
        by a capture the second, by a replay later, counted under
        ``<counter>_eager``, ``<counter>_captures`` and ``<counter>_replays``.
        A replay's output is the graph's own: the next replay of any of
        the cache's keys may overwrite it."""
        how, g = self.sight(key)
        if how == "eager":
            TRACER.count(counter + "_eager")
            return fn(*inputs)
        if how == "capture":
            # copies with real values: the warm-up runs on them
            g = capture(fn, [t.clone() for t in inputs], self.pools)
            self.keep(key, g)
            TRACER.count(counter + "_captures")
        else:
            for s, t in zip(g.inputs, inputs):
                s.copy_(t)
            TRACER.count(counter + "_replays")
        g.graph.replay()  # on the current stream of the card it was captured on
        for name, n in g.counts.items():
            TRACER.count(name, n)
        return g.output


def capture(fn: Callable[..., torch.Tensor], static: List[torch.Tensor],
            pools: Dict[int, tuple]) -> _Graph:
    """Warm up on a side stream, then capture ``fn(*static)`` on the current
    stream of ``static``'s card, into the memory pool that ``pools`` (card
    index -> pool) keeps for it.  ``static`` holds real values (the warm-up
    runs on them), and the graph reads it by address.  The tracer's
    counters come out as they went in, and the graph keeps what the
    captured call added to them."""
    dev = static[0].device
    counters = TRACER.counters
    before = dict(counters)
    with torch.cuda.device(dev):
        pool = pools.get(dev.index)
        if pool is None:
            pool = pools[dev.index] = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*static)
        torch.cuda.current_stream(dev).wait_stream(side)
        warm = dict(counters)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            output = fn(*static)
    counts = {k: v - warm.get(k, 0) for k, v in counters.items() if v != warm.get(k, 0)}
    for k in [k for k in counters if k not in before]:
        del counters[k]
    counters.update(before)
    return _Graph(graph, static, output, counts)
