"""Deterministic synthetic traffic traces (seeded, replayable).

A trace is an ordered list of :class:`TraceRequest` — arrival time, prompt
length, decode budget — generated by a seeded process so the same spec
always yields the byte-identical JSONL artifact:

* :func:`poisson_trace` — homogeneous Poisson arrivals (exponential
  inter-arrival times at a fixed rate);
* :func:`diurnal_trace` — inhomogeneous Poisson via thinning against a
  sinusoidal rate profile ``lam(t) = rate * (1 + (peak-1) * sin^2(pi t /
  period))`` — the load ramp of a day compressed into ``period`` seconds;
* mixed prompt/decode-length distributions through a tiny grammar:
  ``"32"`` (constant), ``"4..64"`` (uniform inclusive) and
  ``"mix:0.8*4..32/0.2*256..512"`` (weighted mixture — the classic
  short-chat / long-document bimodal).

:func:`make_trace` parses the one-line CLI spec
(``poisson:rate=4,n=64,seed=0,plen=4..32,new=8..32``) that
``launch/serve.py --trace`` and the SLO traffic-model registry share.

Randomness derives from ``np.random.SeedSequence([seed, stream-tag])`` so
arrival times, prompt lengths and decode budgets come from independent
streams — editing the length grammar never perturbs the arrival process.

Whole copy of ``src/repro/serve/trace.py`` (numpy only): the same spec
and seed give the same requests, the same JSONL bytes and the same
fingerprint as the reference.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# stream tags: independent SeedSequence children per random purpose
_S_ARRIVAL = 0x41525256          # "ARRV"
_S_PLEN = 0x504C454E             # "PLEN"
_S_NEW = 0x4E455754              # "NEWT"
_S_TOKENS = 0x544F4B53           # "TOKS"


@dataclass(frozen=True)
class TraceRequest:
    """One synthetic request: when it arrives and how big it is."""
    rid: int
    arrival_s: float
    prompt_len: int
    max_new: int

    def to_json(self) -> Dict[str, Union[int, float]]:
        return {"rid": self.rid, "arrival_s": self.arrival_s,
                "prompt_len": self.prompt_len, "max_new": self.max_new}


@dataclass
class Trace:
    """A replayable request stream plus the spec/seed that generated it."""
    name: str
    spec: str
    seed: int
    requests: List[TraceRequest] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def duration_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    @property
    def total_new_tokens(self) -> int:
        return sum(r.max_new for r in self.requests)

    def arrival_rate(self) -> float:
        """Empirical mean arrival rate (requests/s) over the trace span."""
        if len(self.requests) < 2 or self.duration_s <= 0:
            return 0.0
        return (len(self.requests) - 1) / self.duration_s

    # -- serialization -------------------------------------------------
    def to_jsonl(self) -> str:
        """Byte-stable JSONL: one header line + one line per request.

        ``json.dumps`` with sorted keys and repr-roundtripped floats is
        deterministic, so two traces from the same spec+seed serialize
        byte-identically — the property the trace-determinism test pins.
        """
        head = json.dumps({"_trace": {"name": self.name, "spec": self.spec,
                                      "seed": self.seed,
                                      "n": len(self.requests)}},
                          sort_keys=True)
        body = "".join(json.dumps(r.to_json(), sort_keys=True) + "\n"
                       for r in self.requests)
        return head + "\n" + body

    @classmethod
    def from_jsonl(cls, text: str) -> "Trace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace file")
        head = json.loads(lines[0])
        if "_trace" not in head:
            raise ValueError("trace file missing _trace header line")
        meta = head["_trace"]
        reqs = [TraceRequest(rid=int(d["rid"]),
                             arrival_s=float(d["arrival_s"]),
                             prompt_len=int(d["prompt_len"]),
                             max_new=int(d["max_new"]))
                for d in map(json.loads, lines[1:])]
        return cls(name=meta["name"], spec=meta["spec"],
                   seed=int(meta["seed"]), requests=reqs)

    def save(self, path: Union[str, Path]) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl())
        return p

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Trace":
        return cls.from_jsonl(Path(path).read_text())

    def fingerprint(self) -> str:
        """Content digest of the serialized trace (SLO-objective stamp)."""
        return hashlib.sha1(self.to_jsonl().encode()).hexdigest()[:12]

    def prompt_tokens(self, req: TraceRequest, vocab: int) -> np.ndarray:
        """Deterministic synthetic prompt for ``req`` (ids in [1, vocab)).

        Derived from ``(trace seed, rid)`` only, so executors that need
        real token ids (the model path) see the same prompts on every
        replay of the same trace.
        """
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, _S_TOKENS, req.rid]))
        return rng.integers(1, vocab, size=req.prompt_len).astype(np.int32)


# ---------------------------------------------------------------------------
# Length distributions
# ---------------------------------------------------------------------------

class _LengthDist:
    """Parsed length grammar: constant, uniform range, or weighted mixture.

    ``"32"`` — always 32; ``"4..64"`` — uniform integer in [4, 64];
    ``"mix:0.8*4..32/0.2*256..512"`` — choose a component by weight, then
    draw uniformly inside it.  Weights are normalized; lengths are >= 1.
    """

    def __init__(self, spec: str):
        self.spec = spec
        comps: List[Tuple[float, int, int]] = []      # (weight, lo, hi)
        if spec.startswith("mix:"):
            for part in spec[len("mix:"):].split("/"):
                w_s, _, rng_s = part.partition("*")
                lo, hi = _parse_range(rng_s)
                comps.append((float(w_s), lo, hi))
            if not comps:
                raise ValueError(f"empty mixture in length spec {spec!r}")
        else:
            lo, hi = _parse_range(spec)
            comps.append((1.0, lo, hi))
        total = sum(w for w, _, _ in comps)
        if total <= 0:
            raise ValueError(f"length spec {spec!r} has no positive weight")
        self.weights = np.array([w / total for w, _, _ in comps])
        self.bounds = [(lo, hi) for _, lo, hi in comps]

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        comp = rng.choice(len(self.weights), size=n, p=self.weights)
        out = np.empty(n, dtype=np.int64)
        for ci, (lo, hi) in enumerate(self.bounds):
            m = comp == ci
            out[m] = rng.integers(lo, hi + 1, size=int(m.sum()))
        return out


def _parse_range(s: str) -> Tuple[int, int]:
    if ".." in s:
        lo_s, hi_s = s.split("..", 1)
        lo, hi = int(lo_s), int(hi_s)
    else:
        lo = hi = int(s)
    if lo < 1 or hi < lo:
        raise ValueError(f"bad length range {s!r}: need 1 <= lo <= hi")
    return lo, hi


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

def _lengths(seed: int, tag: int, dist: Union[str, _LengthDist],
             n: int) -> np.ndarray:
    d = dist if isinstance(dist, _LengthDist) else _LengthDist(dist)
    return d.sample(np.random.default_rng(
        np.random.SeedSequence([seed, tag])), n)


def _build(name: str, spec: str, seed: int, arrivals: np.ndarray,
           plen: str, new: str) -> Trace:
    n = len(arrivals)
    plens = _lengths(seed, _S_PLEN, plen, n)
    news = _lengths(seed, _S_NEW, new, n)
    reqs = [TraceRequest(rid=i, arrival_s=float(arrivals[i]),
                         prompt_len=int(plens[i]), max_new=int(news[i]))
            for i in range(n)]
    return Trace(name=name, spec=spec, seed=seed, requests=reqs)


def poisson_trace(rate: float, n: int, seed: int = 0,
                  plen: str = "4..32", new: str = "8..32",
                  spec: Optional[str] = None) -> Trace:
    """Homogeneous Poisson arrivals: ``n`` requests at ``rate`` req/s."""
    if rate <= 0 or n < 1:
        raise ValueError(f"poisson trace needs rate > 0 and n >= 1, "
                         f"got rate={rate} n={n}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, _S_ARRIVAL]))
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return _build("poisson", spec or f"poisson:rate={rate:g},n={n},"
                  f"seed={seed},plen={plen},new={new}",
                  seed, arrivals, plen, new)


def diurnal_trace(rate: float, n: int, seed: int = 0,
                  period: float = 120.0, peak: float = 3.0,
                  plen: str = "4..32", new: str = "8..32",
                  spec: Optional[str] = None) -> Trace:
    """Inhomogeneous Poisson arrivals on a diurnal (sinusoidal) ramp.

    Instantaneous rate ``lam(t) = rate * (1 + (peak - 1) * sin^2(pi t /
    period))`` oscillates between ``rate`` (trough) and ``rate * peak``
    (crest) with period ``period`` seconds — a day's load curve compressed
    for replay.  Sampled by Lewis-Shedler thinning against the constant
    envelope ``rate * peak``: candidate arrivals are drawn homogeneous at
    the envelope rate and kept with probability ``lam(t) / envelope``,
    which is exact for any bounded profile.
    """
    if rate <= 0 or n < 1 or peak < 1.0 or period <= 0:
        raise ValueError(
            f"diurnal trace needs rate > 0, n >= 1, peak >= 1, period > 0; "
            f"got rate={rate} n={n} peak={peak} period={period}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, _S_ARRIVAL]))
    envelope = rate * peak
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < n:
        t += float(rng.exponential(1.0 / envelope))
        lam = rate * (1.0 + (peak - 1.0) * math.sin(math.pi * t / period) ** 2)
        if rng.random() < lam / envelope:
            arrivals.append(t)
    return _build("diurnal", spec or f"diurnal:rate={rate:g},n={n},"
                  f"seed={seed},period={period:g},peak={peak:g},"
                  f"plen={plen},new={new}",
                  seed, np.asarray(arrivals), plen, new)


# ---------------------------------------------------------------------------
# Spec grammar
# ---------------------------------------------------------------------------

_KINDS = ("poisson", "diurnal")


def _split_spec(rest: str) -> Dict[str, str]:
    """Split ``k=v,...`` respecting the mixture grammar's '/' and '*'
    (those never contain ',' so a plain comma split is safe)."""
    kw: Dict[str, str] = {}
    for item in filter(None, rest.split(",")):
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(f"trace spec item {item!r} is not k=v")
        kw[k] = v
    return kw


def respec(spec: str, **overrides) -> str:
    """Rebuild ``spec`` with some keys overridden (e.g. ``rate=8.0``).

    The arrival-rate sweep behind the saturation estimate replays the
    same trace shape at a ladder of rates; overriding via the spec string
    (instead of a Trace copy) keeps every replayed trace reproducible
    from its recorded spec.  Keys are validated by the next
    :func:`make_trace` call, not here.
    """
    kind, _, rest = spec.partition(":")
    kw = _split_spec(rest)
    for k, v in overrides.items():
        kw[k] = f"{v:g}" if isinstance(v, float) else str(v)
    return kind + ":" + ",".join(f"{k}={v}" for k, v in kw.items())


def make_trace(spec: str, seed: Optional[int] = None) -> Trace:
    """Build a trace from a one-line spec (CLI / traffic-model grammar).

    ``poisson:rate=4,n=64,seed=0,plen=4..32,new=8..32`` or
    ``diurnal:rate=4,n=64,period=120,peak=3,plen=...,new=...``.  ``seed``
    given as an argument overrides the spec's ``seed=`` key (the
    ``--seed`` CLI convention).  Unknown kinds or keys raise listing what
    is understood.
    """
    kind, _, rest = spec.partition(":")
    if kind not in _KINDS:
        raise ValueError(
            f"unknown trace kind {kind!r} in spec {spec!r}; known kinds: "
            f"{', '.join(_KINDS)} (e.g. 'poisson:rate=4,n=64,"
            f"plen=4..32,new=8..32')")
    kw = _split_spec(rest)
    common = {"rate": float, "n": int, "seed": int}
    extra = {"plen": str, "new": str}
    if kind == "diurnal":
        extra.update({"period": float, "peak": float})
    known = {**common, **extra}
    unknown = sorted(set(kw) - set(known))
    if unknown:
        raise ValueError(
            f"unknown trace spec key(s) {unknown} for kind {kind!r}; "
            f"known: {', '.join(sorted(known))}")
    args = {k: conv(kw[k]) for k, conv in known.items() if k in kw}
    if seed is not None:
        args["seed"] = seed
    args.setdefault("rate", 4.0)
    args.setdefault("n", 64)
    fn = poisson_trace if kind == "poisson" else diurnal_trace
    return fn(spec=spec, **args)
