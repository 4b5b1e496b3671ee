"""The decode step of a cache without KV pages, replayed as one CUDA graph.

The reference jits its decode step once (``jax.jit`` in its serve loop);
eagerly, a pure-SSM step of ``mamba2-370m`` issues about 3,400 small
kernels from Python, and the host takes far longer to issue them than
the card to run them.  Here the eager step (``lm._decode_eager``) is
captured once per model and step shape and each later step replays it:
the same kernels on the same buffers, so the logits, the state and the
tokens are the eager step's bit for bit.

**When** (:func:`takes_graph`, decided from the input): the tokens and
the parameters on a CUDA device, no DTensor, no sharding ``rules``, and a
cache without ``"kv"`` pages.  Such a step is the same launch sequence
at every position: the host int ``cache["pos"]`` only builds the
positions that attention reads through its KV pages, and the SSM cache
is fixed in size and written in place.  Every other step runs eagerly.

**Runners** (:class:`DecodeGraph`) are held per model in a
``WeakKeyDictionary`` (a graph dies with its model), one per batch size
and step settings (token dtype, config, ``use_kernels``).  A runner owns
static buffers: the tokens (B, 1) and a cache shaped as the caller's SSM
part.  Its first call captures the step (kept span
``decode.graph.capture``, attribute B) after a warm-up on a side stream,
in a private memory pool.  Each call (kept span ``decode.graph.replay``)
binds the caller's cache when it is not the runner's (its ``conv`` and
``state`` copied in, once a sequence), copies the tokens in and replays;
it returns a clone of the static logits and the runner's cache with
``pos`` advanced.  From then on the runner's cache *is* the sequence's
cache: the tensors the caller bound are no longer written.

Each cache a runner hands out carries its generation (``graph_gen``);
binding another sequence starts a new one, and a runner cache from an
earlier generation raises instead of computing on another sequence's
state.

The parameters are read in place, so in-place weight updates are seen;
replacing a parameter's storage (``module.to``, assigning ``.data``)
leaves a graph reading the old one: call :func:`drop` for the model.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from .. import obs

GEN_KEY = "graph_gen"
WARMUP = 2          # eager steps on the side stream before the capture

Body = Callable[[torch.Tensor, Dict[str, Any]], Tuple[torch.Tensor, Any]]

_RUNNERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def takes_graph(devices: Iterable[torch.device], dtensor: bool,
                rules: Any, cache_keys: Iterable[str]) -> bool:
    """Whether a decode step replays a graph: every device a CUDA one, no
    DTensor, no sharding rules, and no KV pages in the cache."""
    return (all(d.type == "cuda" for d in devices) and not dtensor
            and rules is None and "kv" not in cache_keys)


class DecodeGraph:
    """One model's decode step at one batch size, captured once and
    replayed (see the module docstring).  ``tokens`` and ``cache`` of the
    first call give the static buffers' shapes and types."""

    def __init__(self, tokens: torch.Tensor, cache: Dict[str, Any]):
        self.tokens = torch.zeros_like(tokens)
        self.ssm = {k: torch.zeros_like(v) for k, v in cache["ssm"].items()}
        self.gen = 0
        self.logits: Optional[torch.Tensor] = None
        self.graph = None

    def _cache(self, pos: int) -> Dict[str, Any]:
        return {"ssm": self.ssm, "pos": pos}

    def _record(self, body: Body, pos: int) -> None:
        """Warm up on a side stream, then capture ``body`` on it into
        ``self.graph`` (in a private pool), its logits left in
        ``self.logits``.  ``capture_begin`` directly, not the
        ``torch.cuda.graph`` context: that one empties the allocator's
        cache first, and the next prefill would ``cudaMalloc`` its blocks
        again."""
        dev = self.tokens.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                body(self.tokens, self._cache(pos))
            torch.cuda.synchronize(dev)
            graph.capture_begin()
            try:
                self.logits, _ = body(self.tokens, self._cache(pos))
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph

    def _replay(self) -> None:
        self.graph.replay()

    def _bind(self, cache: Dict[str, Any]) -> None:
        """Make ``cache`` the runner's: a runner cache of this generation
        passes, one of an earlier generation raises, any other cache is
        copied in and starts a new generation."""
        if cache["ssm"].get("state") is self.ssm["state"]:
            if cache.get(GEN_KEY) != self.gen:
                raise RuntimeError(
                    f"decode graph: cache of generation "
                    f"{cache.get(GEN_KEY)} brought to a runner at "
                    f"generation {self.gen} (another sequence has bound "
                    "the runner since)")
            return
        for k, v in self.ssm.items():
            v.copy_(cache["ssm"][k])
        self.gen += 1

    def __call__(self, body: Body, tokens: torch.Tensor,
                 cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
        pos = cache["pos"]
        if self.graph is None:
            with obs.kept_span("decode.graph.capture", B=tokens.shape[0]):
                self._record(body, pos)
        with obs.kept_span("decode.graph.replay"):
            self._bind(cache)
            self.tokens.copy_(tokens)
            self._replay()
        return self.logits.clone(), dict(cache, ssm=self.ssm, pos=pos + 1,
                                         **{GEN_KEY: self.gen})


def step(model: torch.nn.Module, key: Tuple, body: Body,
         tokens: torch.Tensor, cache: Dict[str, Any]
         ) -> Tuple[torch.Tensor, Dict]:
    """``body(tokens, cache)`` through ``model``'s runner for ``key`` (the
    batch size first), made on first use.  ``body`` is not kept: a runner
    holds no reference to its model."""
    runners = _RUNNERS.setdefault(model, {})
    runner = runners.get(key)
    if runner is None:
        runner = runners[key] = DecodeGraph(tokens, cache)
    return runner(body, tokens, cache)


def runners(model: torch.nn.Module) -> Dict[Tuple, DecodeGraph]:
    """``model``'s runners by key (empty where it has none)."""
    return dict(_RUNNERS.get(model, {}))


def drop(model: torch.nn.Module) -> None:
    """Forget ``model``'s graphs (after replacing a parameter's storage)."""
    _RUNNERS.pop(model, None)
