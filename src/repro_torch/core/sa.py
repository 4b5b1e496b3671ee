"""Simulated-Annealing LP-SPM exploration engine (paper Sec. V-B1).

Five operators, verbatim from the paper:
  OP1  re-factor one layer's Part (product preserved, dim caps respected)
  OP2  swap two cores inside one layer's CG (reorders the Correspondence Rule)
  OP3  swap one core of layer A with one core of layer B
  OP4  move a core from layer A's CG to layer B's CG, re-factor both Parts
  OP5  re-point one explicit FD entry to a random DRAM (0 = interleaved)

The controller picks a layer group with probability proportional to its
optimization-space size (log-domain to avoid overflow), then an applicable
operator uniformly.  Acceptance is Metropolis with geometric cooling.  Only
the touched group is re-evaluated per iteration (the others' costs are
cached), which is what makes large DSEs feasible on one CPU core.

Extension over the paper (noted in DESIGN.md): OP4 may also move a core
to/from the idle pool, so mappings that deliberately leave cores unused are
reachable even though the stripe initialization uses every core.

Copy of ``src/repro/core/sa.py`` on its exact numpy engine: the RNG draws
are consumed in the reference's order, so a seed gives the reference's
trajectory.  ``step_chains_lockstep`` scores each iteration's proposals in
one batched pass (``eval_groups_batched``) on ``SAConfig.backend``:
``"numpy"``, the exact engine, or ``"fused"``, the port's name for the
reference's ``"jax"``: the ``fused_eval`` kernel on the evaluator's
``fused_device``.  ``sa_optimize`` records the reference's ``sa.*``
metrics once a run, after the result is fixed (``repro_torch.obs``).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from .encoding import LMS, MS, Mapping, factor_parts
from .evaluator import CachedEvaluator, Evaluator, GroupEval
from .hw import ArchConfig
from .tangram import tangram_map
from .workload import Graph, LayerGroup


@dataclass
class SAConfig:
    iters: int = 6000
    t0: float = 0.01              # initial temperature, relative to cost
    t_end: float = 1e-5
    seed: int = 0
    beta: float = 1.0             # energy exponent in the objective
    gamma: float = 1.0            # delay exponent
    n_chains: int = 1             # >1 = replica exchange (core/explore.py)
    log_every: int = 0            # 0 = silent
    # replica-exchange knobs (used only when n_chains > 1).  Defaults set
    # by the `misc_bench --retune` sweep over the quick Table-I grid:
    # (2.0, 25) holds ~24% per-pair swap acceptance — inside the healthy
    # 20-40% tempering band — with 2x the exchange events of the old
    # conservative (3.0, 50) at equal-or-better geomean cost.
    swap_every: int = 25          # iterations between adjacent-chain swaps
    t_ladder: float = 2.0         # temperature ratio between adjacent chains
    # n_chains > 1 only: step all chains in lockstep, evaluating the
    # iteration's proposals through one vectorized batch.  Per-chain RNG
    # streams are consumed in the serial order and evaluation consumes
    # none — False keeps the serial per-chain loop for A/B tests.
    lockstep: bool = True
    # "numpy" (default) = exact engine.  "fused" (the reference's "jax") =
    # the fused_eval kernel for lockstep proposal scoring: float32
    # parity-grade (~1e-4), so trajectories may diverge from the exact
    # engine's — but every chain's BEST mapping is still re-scored by the
    # exact engine in finalize(), so reported costs are always exact.  The
    # device is the evaluator's (Evaluator.fused_device).
    backend: str = "numpy"


@dataclass
class SAResult:
    mapping: Mapping
    cost: float
    energy_j: float
    delay_s: float
    history: List[float] = field(default_factory=list)
    accepted: int = 0
    proposed: int = 0
    # replica-exchange diagnostics (n_chains > 1): attempted / executed
    # state swaps per adjacent ladder pair, index k = (ladder chain k,
    # k+1).  Healthy tempering targets ~20-40% acceptance per pair.
    swap_attempts: List[int] = field(default_factory=list)
    swap_accepts: List[int] = field(default_factory=list)

    def swap_rates(self) -> List[float]:
        return [a / t for a, t in zip(self.swap_accepts, self.swap_attempts)
                if t > 0]


def _group_weights(group_sizes: Sequence[int], n_cores: int) -> np.ndarray:
    logs = []
    for n in group_sizes:
        try:
            # log of the paper's lower bound, via lgamma to stay in float
            from math import comb, lgamma
            s = 0
            for i in range(n):
                s += comb(n, i) * comb(max(0, n_cores - n - 1), n - i - 1) \
                    * 4 ** (n - i)
            logs.append(lgamma(n_cores + 1) + math.log(max(s, 1)))
        except (OverflowError, ValueError):
            logs.append(float(n_cores))
    w = np.array(logs)
    w = np.maximum(w, 1e-6)
    return w / w.sum()


class _Op:
    """Applies one operator to (a copy of) a group LMS.  Returns None if N/A."""

    def __init__(self, g: Graph, arch: ArchConfig, rng: np.random.Generator):
        self.g = g
        self.arch = arch
        self.rng = rng

    def _dims(self, name: str, grp: LayerGroup) -> Tuple[int, int, int, int]:
        l = self.g.layers[name]
        return (l.H, l.W, grp.batch_unit, l.K)

    def _pick(self, seq):
        # index draw: rng.choice() converts the sequence to an ndarray on
        # every call, which dominates proposal cost in tight SA loops
        return seq[int(self.rng.integers(len(seq)))]

    def _pick2(self, n: int) -> Tuple[int, int]:
        """Two distinct indices in [0, n), uniform over ordered pairs."""
        i = int(self.rng.integers(n))
        j = int(self.rng.integers(n - 1))
        return i, j + (j >= i)

    def op1(self, grp: LayerGroup, lms: LMS) -> Optional[LMS]:
        name = self._pick(grp.names)
        ms = lms.ms[name]
        try:
            part = factor_parts(ms.nc, self._dims(name, grp), self.rng)
        except ValueError:
            return None
        if part == ms.part:
            return None
        new = dict(lms.ms)
        new[name] = replace(ms, part=part)
        return LMS(ms=new)

    def op2(self, grp: LayerGroup, lms: LMS) -> Optional[LMS]:
        cands = [n for n in grp.names if lms.ms[n].nc >= 2]
        if not cands:
            return None
        name = self._pick(cands)
        ms = lms.ms[name]
        i, j = self._pick2(ms.nc)
        cg = list(ms.cg)
        cg[i], cg[j] = cg[j], cg[i]
        new = dict(lms.ms)
        new[name] = replace(ms, cg=tuple(cg))
        return LMS(ms=new)

    def op3(self, grp: LayerGroup, lms: LMS) -> Optional[LMS]:
        if len(grp.names) < 2:
            return None
        a, b = self._pick2(len(grp.names))
        na, nb = grp.names[a], grp.names[b]
        ma, mb = lms.ms[na], lms.ms[nb]
        ia = int(self.rng.integers(ma.nc))
        ib = int(self.rng.integers(mb.nc))
        cga, cgb = list(ma.cg), list(mb.cg)
        cga[ia], cgb[ib] = cgb[ib], cga[ia]
        new = dict(lms.ms)
        new[na] = replace(ma, cg=tuple(cga))
        new[nb] = replace(mb, cg=tuple(cgb))
        return LMS(ms=new)

    def op4(self, grp: LayerGroup, lms: LMS,
            idle: Sequence[int]) -> Optional[Tuple[LMS, List[int]]]:
        """Move a core between layers (or to/from the idle pool).  Pure:
        returns (new_lms, new_idle) without mutating the inputs."""
        names = list(grp.names)
        new_idle = list(idle)
        donors = [n for n in names if lms.ms[n].nc >= 2]
        use_idle_donor = bool(new_idle) and self.rng.random() < 0.25
        if not donors and not use_idle_donor:
            return None
        new = dict(lms.ms)
        if use_idle_donor:
            core = new_idle.pop(int(self.rng.integers(len(new_idle))))
            donor = None
        else:
            donor = self._pick(donors)
            md = new[donor]
            di = int(self.rng.integers(md.nc))
            core = md.cg[di]
            cgd = md.cg[:di] + md.cg[di + 1:]
            try:
                pd = factor_parts(len(cgd), self._dims(donor, grp), self.rng)
            except ValueError:
                return None
            new[donor] = MS(part=pd, cg=cgd, fd=md.fd)
        # receiver: another layer, or (rarely) the idle pool
        recv_idle = donor is not None and self.rng.random() < 0.10
        recv_cands = [n for n in names if n != donor]
        if recv_idle or not recv_cands:
            if donor is None:
                return None              # idle -> idle is a no-op
            new_idle.append(core)
        else:
            recv = self._pick(recv_cands)
            mr = new[recv]
            pos = int(self.rng.integers(mr.nc + 1))
            cgr = mr.cg[:pos] + (core,) + mr.cg[pos:]
            try:
                pr = factor_parts(len(cgr), self._dims(recv, grp), self.rng)
            except ValueError:
                return None
            new[recv] = MS(part=pr, cg=cgr, fd=mr.fd)
        return LMS(ms=new), new_idle

    def op5(self, grp: LayerGroup, lms: LMS) -> Optional[LMS]:
        cands = [(n, i) for n in grp.names
                 for i, v in enumerate(lms.ms[n].fd) if v >= 0]
        if not cands:
            return None
        name, i = cands[int(self.rng.integers(len(cands)))]
        ms = lms.ms[name]
        v = int(self.rng.integers(0, self.arch.n_dram + 1))
        if v == ms.fd[i]:
            return None
        fd = list(ms.fd)
        fd[i] = v
        new = dict(lms.ms)
        new[name] = replace(ms, fd=tuple(fd))
        return LMS(ms=new)


@lru_cache(maxsize=4096)
def _group_cdf_cached(group_sizes: Tuple[int, ...], n_cores: int) -> np.ndarray:
    """One CDF per (group-size vector, core count), computed once per
    process.  ``_group_weights`` reads nothing but each group's layer
    count, so every chain, every candidate of a sweep and every re-anneal
    over the same (graph partition, arch) shares this array instead of
    re-deriving the log-space weights per ``sa_optimize`` call.  The array
    is shared read-only (chains only ``searchsorted`` it)."""
    cum_w = np.cumsum(_group_weights(group_sizes, n_cores))
    cum_w[-1] = 1.0
    cum_w.setflags(write=False)
    return cum_w


def group_draw_cdf(groups: Sequence[LayerGroup], n_cores: int) -> np.ndarray:
    """Cumulative group-pick distribution shared by all chains of one run.

    Inverse-CDF group draw: ``rng.choice(..., p=weights)`` re-normalizes and
    allocates on every call, so chains draw via ``np.searchsorted`` instead.
    Cached per (group sizes, n_cores) — the only inputs the weights read.
    """
    return _group_cdf_cached(tuple(len(grp.names) for grp in groups),
                             n_cores)


class SAChain:
    """One Metropolis chain over the LP-SPM space, advanced one iteration at
    a time so an orchestrator (``core/explore.py``) can interleave chains and
    exchange their states (parallel tempering).

    ``step()`` consumes RNG draws in exactly the order of the original
    monolithic loop (group pick, operator pick, operator-internal draws,
    acceptance draw), so a single chain's trajectory for a given seed is
    unchanged by this refactor.
    """

    def __init__(self, g: Graph, arch: ArchConfig, groups: Sequence[LayerGroup],
                 total_batch: int, cfg: SAConfig, init: Optional[Mapping],
                 ev: Evaluator, seed: int, cum_w: np.ndarray,
                 t_scale: float = 1.0):
        self.cfg = cfg
        self.ev = ev
        self.total_batch = total_batch
        self.rng = np.random.default_rng(seed)
        self.mapping: Mapping = [
            (grp, lms) for grp, lms in
            (init if init is not None else tangram_map(groups, g, arch))]
        # idle cores per group
        self.idle: List[List[int]] = []
        for grp, lms in self.mapping:
            used = set(lms.cores_used())
            self.idle.append([c for c in range(arch.n_cores) if c not in used])
        self.evals: List[GroupEval] = []
        for grp, lms in self.mapping:
            ge, _ = ev.eval_group(grp, lms, total_batch)
            self.evals.append(ge)
        self.E = sum(e.energy_j for e in self.evals)
        self.D = sum(e.delay_s for e in self.evals)
        self.cost = (self.E ** cfg.beta) * (self.D ** cfg.gamma)
        self.best_cost = self.cost
        self.best_map: Mapping = list(self.mapping)
        self.cum_w = cum_w
        self.ops = _Op(g, arch, self.rng)
        self.T = cfg.t0 * self.cost * t_scale
        self.alpha = (cfg.t_end / cfg.t0) ** (1.0 / max(1, cfg.iters))
        self.accepted = 0
        self.proposed = 0

    def propose(self) -> Optional[Tuple[int, LayerGroup, LMS,
                                        Optional[List[int]]]]:
        """Draw one proposal and apply cooling — the head of the original
        monolithic ``step()``, consuming RNG draws in exactly its order
        (group pick, operator pick, operator-internal draws).  Returns
        ``None`` when the drawn operator is inapplicable, else
        ``(gi, grp, cand, new_idle)`` for :meth:`accept`."""
        rng, ops = self.rng, self.ops
        gi = int(np.searchsorted(self.cum_w, rng.random(), side="right"))
        grp, lms = self.mapping[gi]
        op = int(rng.integers(1, 6))
        new_idle: Optional[List[int]] = None
        if op == 1:
            cand = ops.op1(grp, lms)
        elif op == 2:
            cand = ops.op2(grp, lms)
        elif op == 3:
            cand = ops.op3(grp, lms)
        elif op == 4:
            r4 = ops.op4(grp, lms, self.idle[gi])
            cand, new_idle = r4 if r4 is not None else (None, None)
        else:
            cand = ops.op5(grp, lms)
        self.T *= self.alpha
        if cand is None:
            return None
        self.proposed += 1
        return gi, grp, cand, new_idle

    def accept(self, gi: int, grp: LayerGroup, cand: LMS,
               new_idle: Optional[List[int]], ge: GroupEval) -> None:
        """Metropolis acceptance of an evaluated proposal — the tail of the
        original ``step()`` (the acceptance draw is this chain's next RNG
        use after the proposal draws, evaluation consumes none)."""
        cfg, rng = self.cfg, self.rng
        old = self.evals[gi]
        newE = self.E - old.energy_j + ge.energy_j
        newD = self.D - old.delay_s + ge.delay_s
        new_cost = (newE ** cfg.beta) * (newD ** cfg.gamma)
        if new_cost <= self.cost or rng.random() < math.exp(
                min(0.0, -(new_cost - self.cost) / max(self.T, 1e-30))):
            self.mapping[gi] = (grp, cand)
            self.evals[gi] = ge
            if new_idle is not None:
                self.idle[gi] = new_idle
            self.cost, self.E, self.D = new_cost, newE, newD
            self.accepted += 1
            self._track_best()

    def step(self) -> None:
        """One proposal + cooling step (Metropolis acceptance)."""
        prop = self.propose()
        if prop is None:
            return
        gi, grp, cand, new_idle = prop
        ge, _ = self.ev.eval_group(grp, cand, self.total_batch)
        self.accept(gi, grp, cand, new_idle, ge)

    def _track_best(self) -> None:
        if self.cost < self.best_cost:
            self.best_cost = self.cost
            self.best_map = list(self.mapping)

    def exchange_state(self, other: "SAChain") -> None:
        """Swap the *configurations* of two chains (replica exchange).

        Temperatures, RNG streams and per-chain bests stay put — only the
        walker (mapping, idle pools, incremental cost terms) moves between
        temperature rungs.  Both chains re-check their best afterwards so a
        state arriving from a hotter rung is never lost.
        """
        for attr in ("mapping", "idle", "evals", "cost", "E", "D"):
            mine, theirs = getattr(self, attr), getattr(other, attr)
            setattr(self, attr, theirs)
            setattr(other, attr, mine)
        self._track_best()
        other._track_best()

    def finalize(self, history: List[float]) -> SAResult:
        """Exact re-evaluation of the best mapping found by this chain."""
        final = self.ev.evaluate(self.best_map, self.total_batch)
        return SAResult(mapping=self.best_map,
                        cost=final.cost(self.cfg.beta, self.cfg.gamma),
                        energy_j=final.energy_j, delay_s=final.delay_s,
                        history=history, accepted=self.accepted,
                        proposed=self.proposed)


BACKENDS = ("numpy", "fused")


def check_backend(backend: str) -> None:
    """Refuse an ``SAConfig.backend`` the port does not have, with the
    reference's unknown-backend error (its ``"jax"`` is ``"fused"`` here)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown eval batch backend {backend!r}; the "
                         f"port's are {BACKENDS} ('fused' is the "
                         f"reference's 'jax')")


def step_chains_lockstep(chains: Sequence[SAChain],
                         backend: str = "numpy") -> None:
    """Advance every chain one iteration with ONE batched evaluation.

    Phase 1 draws each chain's proposal with its own RNG (same per-chain
    draw order as serial ``step()``).  Phase 2 evaluates all drawn
    candidates through the shared evaluator's batch path
    (``eval_groups_batched``: deduplicated, one replay for the iteration).
    Phase 3 runs the Metropolis acceptances in chain order, each consuming
    only its own chain's RNG.  Evaluation consumes no randomness, so every
    chain's trajectory equals the serial loop's as far as the batched
    scores equal the scalar ones (the reference's batched numpy path is an
    ulp off its scalar path on Python 3.12, and so is the port's).

    ``backend="fused"`` scores the iteration's proposals through the fused
    pass instead: parity-grade float32 objectives (trajectories may diverge
    from the exact engine's), with each chain's best re-scored exactly at
    finalize().
    """
    props = [ch.propose() for ch in chains]
    live = [(i, p) for i, p in enumerate(props) if p is not None]
    if not live:
        return
    ev = chains[0].ev
    total_batch = chains[0].total_batch
    results = ev.eval_groups_batched(
        [(p[1], p[2]) for _, p in live], total_batch, backend=backend)
    for (i, (gi, grp, cand, new_idle)), (ge, _) in zip(live, results):
        chains[i].accept(gi, grp, cand, new_idle, ge)


def sa_optimize(g: Graph, arch: ArchConfig, groups: Sequence[LayerGroup],
                total_batch: int, cfg: SAConfig,
                init: Optional[Mapping] = None,
                evaluator: Optional[Evaluator] = None) -> SAResult:
    """Run the SA engine; returns the best mapping found.

    ``n_chains == 1`` runs the classic single chain.  ``n_chains > 1`` runs
    replica-exchange SA (parallel tempering) over a temperature ladder with
    one shared content-addressed evaluator cache — see
    :func:`repro_torch.core.explore.replica_exchange_sa`.

    ``n_chains == 2`` is a degenerate ladder: chain 0 is the unswapped
    reference, leaving a one-chain ladder with nothing to exchange with —
    two independent seeds plus elitism, not tempering.  Asking for 2 warns
    and runs the documented minimum useful ladder (3) instead.
    """
    check_backend(cfg.backend)
    if cfg.n_chains <= 1:
        return _sa_chain(g, arch, groups, total_batch, cfg, init, evaluator)
    if cfg.n_chains == 2:
        warnings.warn(
            "SAConfig(n_chains=2) degenerates to independent seeds + "
            "elitism (chain 0 is the unswapped reference, so the tempering "
            "ladder has one chain and no swaps can occur); running "
            "n_chains=3, the minimum useful ladder",
            RuntimeWarning, stacklevel=2)
        cfg = replace(cfg, n_chains=3)
    from .explore import replica_exchange_sa   # lazy: avoids import cycle
    return replica_exchange_sa(g, arch, groups, total_batch, cfg,
                               init=init, evaluator=evaluator)


def _sa_chain(g: Graph, arch: ArchConfig, groups: Sequence[LayerGroup],
              total_batch: int, cfg: SAConfig, init: Optional[Mapping],
              evaluator: Optional[Evaluator]) -> SAResult:
    # content-addressed GroupEval cache: re-proposals, repeated chains and
    # the final exact re-evaluation hit it; results are identical either way
    ev = evaluator or CachedEvaluator(arch, g)
    chain = SAChain(g, arch, groups, total_batch, cfg, init, ev,
                    seed=cfg.seed, cum_w=group_draw_cdf(groups, arch.n_cores))
    history: List[float] = []
    for it in range(cfg.iters):
        chain.step()
        # unconditional: history length depends only on iters/log_every,
        # not on how many proposals happened to be applicable
        if cfg.log_every and it % cfg.log_every == 0:
            history.append(chain.cost)
    res = chain.finalize(history)
    if _obs.enabled():                     # once per SA run, post-result
        _obs.metrics.counter("sa.runs").inc()
        _obs.metrics.counter("sa.proposed").inc(res.proposed)
        _obs.metrics.counter("sa.accepted").inc(res.accepted)
        if res.proposed:
            _obs.metrics.histogram("sa.acceptance_rate").observe(
                res.accepted / res.proposed)
    return res
