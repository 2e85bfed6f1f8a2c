"""Autotuning: Bayesian optimization of communication knobs.

The PyTorch counterpart of the JAX package's ``autotune.py``: its
Gaussian process, expected-improvement optimizer and parameter manager
are numpy and are kept here as the port's own copy, with every knob
column and every ``HVDT_AUTOTUNE_*`` knob and seed of the reference.

Tuned knobs: ``log2_bucket_bytes`` (the fusion threshold of the
exchange) and ``overlap_buckets``, plus the optional dimensions
(fused optimizer, quantized wire leg, overlap schedule, transport,
ZeRO, MoE capacity, pipeline microbatches).  Score: gradient bytes a
second.

:class:`BenchmarkAutotuner` syncs rank 0's choice over the process
group's c10d store (``ops/control_plane.StoreControlPlane``), so every
rank rebuilds the same step.  :class:`AutotunedStep` is the ``HVDT_AUTOTUNE``
engagement: with the knob unset it calls ``builder(None)`` once and
dispatches straight to the step; with it set it times
``steps_per_sample``-step regions, each closed by a host fetch of the
step's smallest output (the loss), rebuilds the step through the
builder's keywords when the knobs move and discards the first region
after a rebuild.  A builder that returns a ``step_pipeline.donated_step``
makes each rebuild a fresh capture, and the old graph is released with
the old step.

``HVDT_AUTOTUNE_MODEL_SEED`` consults the static cost model, which is
not ported (ROADMAP Queue 1 item 8): set to anything but off it raises
``NotImplementedError`` where the reference would read the model.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import logging

from .common import config

log = logging.getLogger(__name__)

__all__ = ["GaussianProcess", "BayesianOptimizer", "ParameterManager",
           "BenchmarkAutotuner", "AutotunedStep", "autotuned_step"]


class GaussianProcess:
    """RBF-kernel GP regression (ref: optim/gaussian_process.{h,cc}).

    Hyperparameters are fixed (length_scale per-dim, signal/noise variance)
    rather than L-BFGS-optimized — adequate for the handful of samples the
    tuner sees, and dependency-free.
    """

    def __init__(self, length_scale: float = 1.0, signal_var: float = 1.0,
                 noise: float = 0.1):
        self.length_scale = length_scale
        self.signal_var = signal_var
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None
        self._l_chol: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return self.signal_var * np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.atleast_2d(np.asarray(x, float))
        self._y = np.asarray(y, float).reshape(-1)
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise
        self._l_chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._l_chol.T, np.linalg.solve(self._l_chol, self._y))

    def predict(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and stddev at query points."""
        x = np.atleast_2d(np.asarray(x, float))
        if self._x is None:
            return np.zeros(len(x)), np.full(len(x),
                                             math.sqrt(self.signal_var))
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._l_chol, ks.T)
        var = self.signal_var - (v ** 2).sum(0)
        return mean, np.sqrt(np.maximum(var, 1e-12))


class BayesianOptimizer:
    """Expected-improvement acquisition over a candidate grid
    (ref: optim/bayesian_optimization.{h,cc})."""

    def __init__(self, candidates: np.ndarray, noise: float = 0.1,
                 xi: float = 0.01):
        self.candidates = np.atleast_2d(np.asarray(candidates, float))
        self.gp = GaussianProcess(noise=noise)
        self.xi = xi
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []

    def observe(self, x: Sequence[float], y: float) -> None:
        self._xs.append(np.asarray(x, float))
        self._ys.append(float(y))
        # Z-score-normalize scores before fitting: raw bytes/sec (~1e9)
        # against a unit-variance kernel would collapse EI to 0 everywhere
        # (the reference normalizes in ParameterManager too).
        ys = np.asarray(self._ys)
        std = float(ys.std())
        self._y_scale = std if std > 0 else 1.0
        self._y_shift = float(ys.mean())
        self._yn = (ys - self._y_shift) / self._y_scale
        self.gp.fit(np.stack(self._xs), self._yn)

    def suggest(self) -> np.ndarray:
        if not self._xs:
            return self.candidates[0]
        mean, std = self.gp.predict(self.candidates)
        best = float(self._yn.max())
        z = (mean - best - self.xi) / std
        phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        ei = (mean - best - self.xi) * cdf + std * phi
        # Avoid re-suggesting seen points (in EI and in the fallback).
        seen_mask = np.zeros(len(self.candidates), bool)
        for seen in self._xs:
            seen_mask |= np.all(np.isclose(self.candidates, seen), axis=1)
        ei[seen_mask] = -1
        if np.all(ei <= 0):
            fallback = np.where(seen_mask, -np.inf, mean)
            if np.all(np.isneginf(fallback)):  # every candidate visited
                return self.candidates[int(np.argmax(mean))]
            return self.candidates[int(np.argmax(fallback))]
        return self.candidates[int(np.argmax(ei))]

    @property
    def best(self) -> Tuple[np.ndarray, float]:
        i = int(np.argmax(self._ys))
        return self._xs[i], self._ys[i]


@dataclasses.dataclass
class _Sample:
    point: np.ndarray
    bytes_total: float = 0.0
    seconds: float = 0.0
    steps: int = 0

    @property
    def score(self) -> float:
        return self.bytes_total / self.seconds if self.seconds > 0 else 0.0


class ParameterManager:
    """Online tuner with warmup → sample → done lifecycle
    (ref: common/parameter_manager.cc Update/Tune/LogParameters).

    Usage::

        pm = ParameterManager()
        for step in range(...):
            t0 = time.perf_counter()
            ...train step using pm.bucket_bytes...
            pm.record(grad_bytes, time.perf_counter() - t0)
    """

    LOG2_BUCKET_CANDIDATES = tuple(range(20, 29))     # 1 MiB .. 256 MiB
    OVERLAP_CANDIDATES = (1, 2, 4)
    FUSED_OPTIMIZER_CANDIDATES = (0.0, 1.0)
    # 0 = f32, 1 = int8, 2 = int4 (the quant_leg encoding): one knob
    # column, three wire legs, all state-compatible hot-swaps.
    QUANT_CANDIDATES = (0.0, 1.0, 2.0)
    OVERLAP_SCHEDULE_CANDIDATES = (0.0, 1.0)
    TRANSPORT_CANDIDATES = (0.0, 1.0)
    ZERO_CANDIDATES = (0.0, 1.0)
    # Expert capacity factors (parallel/moe.py): dispatch payload and
    # dropped-token fraction trade directly against each other.
    MOE_CAPACITY_CANDIDATES = (1.0, 1.25, 1.5, 2.0)
    # log2(microbatch count) for the 1F1B clock (parallel/pipeline.py):
    # 4..32 microbatches — bubble fraction (p-1)/(m+p-1) vs per-tick
    # ppermute payload.
    PIPELINE_LOG2_MICROBATCH_CANDIDATES = (2.0, 3.0, 4.0, 5.0)

    def __init__(self,
                 warmup_samples: Optional[int] = None,
                 steps_per_sample: Optional[int] = None,
                 max_samples: Optional[int] = None,
                 log_file: Optional[str] = None,
                 noise: Optional[float] = None,
                 tune_fused_optimizer: Optional[bool] = None,
                 tune_quant: Optional[bool] = None,
                 tune_overlap: Optional[bool] = None,
                 tune_transport: Optional[bool] = None,
                 tune_zero: Optional[bool] = None,
                 tune_moe: Optional[bool] = None,
                 tune_pipeline: Optional[bool] = None):
        self.warmup = (warmup_samples if warmup_samples is not None
                       else config.get_int("HVDT_AUTOTUNE_WARMUP_SAMPLES"))
        self.steps_per_sample = (
            steps_per_sample if steps_per_sample is not None
            else config.get_int("HVDT_AUTOTUNE_STEPS_PER_SAMPLE"))
        self.max_samples = (
            max_samples if max_samples is not None
            else config.get_int("HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"))
        noise = (noise if noise is not None
                 else config.get_float("HVDT_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"))
        self._log_file = log_file or config.get_str("HVDT_AUTOTUNE_LOG") or None
        # Optional third knob dimension: fused-vs-unfused optimizer
        # kernels (ops/optim_kernels) — a 0/1 A/B the GP searches
        # jointly with the comm knobs, since comm/compute overlap and
        # the update's HBM footprint interact.
        self.tune_fused = (
            tune_fused_optimizer if tune_fused_optimizer is not None
            else config.get_bool("HVDT_AUTOTUNE_FUSED_OPTIMIZER"))
        # Optional fourth dimension: the quantized gradient-wire leg
        # (quant/; f32/int8/int4) — comm bytes and step time
        # trade against quantize/dequantize compute, so the GP prices
        # the wire jointly with the bucketing it directly interacts
        # with.
        self.tune_quant = (tune_quant if tune_quant is not None
                           else config.get_bool("HVDT_AUTOTUNE_QUANT"))
        # Optional fifth dimension: overlap-schedule on/off
        # (ops/overlap.py) — whether the dependency-ordered, pipelined
        # exchange beats the monolithic fused path depends on the very
        # bucketing the GP already searches, so they are priced jointly.
        # Both legs keep one optimizer state tree (the schedule changes
        # the exchange, never state), so the hot swap is a rebuild only.
        self.tune_overlap = (tune_overlap if tune_overlap is not None
                             else config.get_bool("HVDT_AUTOTUNE_OVERLAP"))
        # Optional sixth dimension: flat-vs-hierarchical transport
        # (transport/) — whether the two-level fast-axis/
        # slow-axis schedule beats the flat collective depends on the
        # bucketing and wire already searched, so the GP prices the
        # policy jointly.  Both legs keep one optimizer state tree (the
        # policy changes the collectives, never state), so the hot swap is a
        # rebuild only.  The starting leg is MEASURED when
        # HVDT_AUTOTUNE_TRANSPORT_SEED points at a bench_allreduce
        # sweep (hierarchical_speedup_vs_flat_at_peak > 1).
        self.tune_transport = (
            tune_transport if tune_transport is not None
            else config.get_bool("HVDT_AUTOTUNE_TRANSPORT"))
        # Optional seventh dimension: replicated-vs-ZeRO-sharded
        # exchange/update (ops/zero.py) — reduce-scatter wire + sharded
        # state trades an extra allgather against n-fold-smaller
        # optimizer HBM (bigger batches), so the GP prices it jointly
        # with bucketing and wire.  Both legs keep ONE sharded state
        # tree (the replicated leg exchanges via allreduce and slices
        # its shard — same layout, different wire), so the hot swap is
        # a rebuild only.  The starting leg is MEASURED when
        # HVDT_AUTOTUNE_ZERO_SEED points at a bench_allreduce
        # --reduce-scatter sweep (rs_ag_speedup_vs_allreduce_at_peak
        # > 1).
        self.tune_zero = (tune_zero if tune_zero is not None
                          else config.get_bool("HVDT_AUTOTUNE_ZERO"))
        # Optional eighth dimension: expert capacity factor
        # (parallel/moe.py) — a2a dispatch bytes scale linearly with
        # capacity while the dropped-token fraction falls, and the
        # break-even moves with the dispatch wire the GP is already
        # pricing, so they are searched jointly.  Hot-swappable: the
        # capacity changes the dispatch layout (a rebuild), never
        # optimizer state.  The starting leg is the explicit
        # HVDT_MOE_CAPACITY_FACTOR, the MEASURED
        # HVDT_AUTOTUNE_MOE_SEED verdict, or the cost model's a2a-wire
        # ordering.
        self.tune_moe = (tune_moe if tune_moe is not None
                         else config.get_bool("HVDT_AUTOTUNE_MOE"))
        # Optional ninth dimension: 1F1B microbatch count
        # (parallel/pipeline.py) — more microbatches shrink the bubble
        # (p-1)/(m+p-1) but shrink every ppermute tick's payload toward
        # the latency floor, the same alpha/beta trade the bucket-size
        # dimension walks, so the GP prices them jointly.
        # Hot-swappable: the clock changes the schedule, never state.
        self.tune_pipeline = (
            tune_pipeline if tune_pipeline is not None
            else config.get_bool("HVDT_AUTOTUNE_PIPELINE"))
        # Column layout: [log2_bucket, overlap] (+fused) (+quant)
        # (+overlap_schedule) (+transport) (+zero) (+moe) (+pipeline).
        self._quant_col = (2 + int(self.tune_fused)) if self.tune_quant \
            else None
        self._overlap_col = (
            2 + int(self.tune_fused) + int(self.tune_quant)
        ) if self.tune_overlap else None
        self._transport_col = (
            2 + int(self.tune_fused) + int(self.tune_quant)
            + int(self.tune_overlap)
        ) if self.tune_transport else None
        self._zero_col = (
            2 + int(self.tune_fused) + int(self.tune_quant)
            + int(self.tune_overlap) + int(self.tune_transport)
        ) if self.tune_zero else None
        self._moe_col = (
            2 + int(self.tune_fused) + int(self.tune_quant)
            + int(self.tune_overlap) + int(self.tune_transport)
            + int(self.tune_zero)
        ) if self.tune_moe else None
        self._pipeline_col = (
            2 + int(self.tune_fused) + int(self.tune_quant)
            + int(self.tune_overlap) + int(self.tune_transport)
            + int(self.tune_zero) + int(self.tune_moe)
        ) if self.tune_pipeline else None
        import itertools

        dims = [self.LOG2_BUCKET_CANDIDATES, self.OVERLAP_CANDIDATES]
        if self.tune_fused:
            dims.append(self.FUSED_OPTIMIZER_CANDIDATES)
        if self.tune_quant:
            dims.append(self.QUANT_CANDIDATES)
        if self.tune_overlap:
            dims.append(self.OVERLAP_SCHEDULE_CANDIDATES)
        if self.tune_transport:
            dims.append(self.TRANSPORT_CANDIDATES)
        if self.tune_zero:
            dims.append(self.ZERO_CANDIDATES)
        if self.tune_moe:
            dims.append(self.MOE_CAPACITY_CANDIDATES)
        if self.tune_pipeline:
            dims.append(self.PIPELINE_LOG2_MICROBATCH_CANDIDATES)
        grid = np.array(list(itertools.product(*dims)), float)
        self._bo = BayesianOptimizer(grid, noise=noise)
        start = [math.log2(config.get_int("HVDT_FUSION_THRESHOLD")), 1.0]
        if self.tune_fused:
            start.append(float(config.get_bool("HVDT_FUSED_OPTIMIZER")))
        if self.tune_quant:
            start.append(_LEG_VALUES[_env_quant_leg()])
        if self.tune_overlap:
            start.append(float(_env_overlap()))
        if self.tune_transport:
            start.append(float(_env_transport()))
        if self.tune_zero:
            start.append(float(_env_zero()))
        if self.tune_moe:
            start.append(_env_capacity_factor())
        if self.tune_pipeline:
            start.append(math.log2(_env_microbatches()))
        self._current = np.array(start)
        self._sample = _Sample(self._current)
        self._samples_done = 0
        self._warmups_done = 0
        self._done = False

    # -- knob views --------------------------------------------------------

    @property
    def bucket_bytes(self) -> int:
        return int(2 ** self._current[0])

    @property
    def overlap_buckets(self) -> int:
        return int(self._current[1])

    @property
    def fused_optimizer(self) -> bool:
        """Current fused-optimizer A/B choice; outside the tuned
        dimension it reports the HVDT_FUSED_OPTIMIZER default."""
        if self.tune_fused:
            return bool(self._current[2] >= 0.5)
        return config.get_bool("HVDT_FUSED_OPTIMIZER")

    @property
    def quant_wire(self) -> bool:
        """Current quantized-vs-f32 wire choice (any quantized leg);
        outside the tuned dimension it reports the HVDT_QUANT /
        HVDT_COMPRESSION env default."""
        if self.tune_quant:
            return bool(self._current[self._quant_col] >= 0.5)
        return _env_quant_wire()

    @property
    def quant_leg(self) -> str:
        """Current wire leg by name — "f32", "int8" or "int4" (the
        0/1/2 knob encoding); outside the tuned dimension it reports
        the env default leg."""
        if self.tune_quant:
            v = float(self._current[self._quant_col])
            return "int4" if v >= 1.5 else ("int8" if v >= 0.5 else "f32")
        return _env_quant_leg()

    @property
    def overlap_schedule(self) -> bool:
        """Current overlap-schedule on/off choice; outside the tuned
        dimension it reports the HVDT_OVERLAP env default."""
        if self.tune_overlap:
            return bool(self._current[self._overlap_col] >= 0.5)
        return _env_overlap()

    @property
    def transport_policy(self) -> bool:
        """Current flat-vs-hierarchical transport choice; outside the
        tuned dimension it reports the HVDT_TRANSPORT / seed-file env
        default."""
        if self.tune_transport:
            return bool(self._current[self._transport_col] >= 0.5)
        return _env_transport()

    @property
    def zero_sharding(self) -> bool:
        """Current replicated-vs-ZeRO-sharded choice; outside the tuned
        dimension it reports the HVDT_ZERO / seed-file env default."""
        if self.tune_zero:
            return bool(self._current[self._zero_col] >= 0.5)
        return _env_zero()

    @property
    def capacity_factor(self) -> float:
        """Current expert capacity-factor choice; outside the tuned
        dimension it reports the HVDT_MOE_CAPACITY_FACTOR / seed-file
        default."""
        if self.tune_moe:
            return float(self._current[self._moe_col])
        return _env_capacity_factor()

    @property
    def num_microbatches(self) -> int:
        """Current 1F1B microbatch-count choice (the log2 knob decoded);
        outside the tuned dimension it reports the
        HVDT_PIPELINE_MICROBATCHES / seed-file default."""
        if self.tune_pipeline:
            return int(round(2 ** self._current[self._pipeline_col]))
        return _env_microbatches()

    @property
    def tuning_complete(self) -> bool:
        return self._done

    # -- feeding -----------------------------------------------------------

    def record(self, grad_bytes: float, seconds: float) -> bool:
        """Record one step; returns True when knob values just changed
        (caller should rebuild its step)."""
        if self._done:
            return False
        s = self._sample
        s.bytes_total += grad_bytes
        s.seconds += seconds
        s.steps += 1
        if s.steps < self.steps_per_sample:
            return False
        return self._finish_sample()

    def _finish_sample(self) -> bool:
        s = self._sample
        if self._warmups_done < self.warmup:
            self._warmups_done += 1
            self._sample = _Sample(self._current)
            return False
        self._bo.observe(s.point, s.score)
        self._log(s)
        self._samples_done += 1
        if self._samples_done >= self.max_samples:
            best_x, best_y = self._bo.best
            self._current = best_x
            self._done = True
            log.info("autotune done: bucket=%d MiB overlap=%d (%.1f MB/s)",
                     self.bucket_bytes // 2 ** 20, self.overlap_buckets,
                     best_y / 1e6)
            return True
        self._current = self._bo.suggest()
        self._sample = _Sample(self._current)
        return True

    def _log(self, s: _Sample) -> None:
        if not self._log_file:
            return
        try:
            with open(self._log_file, "a", newline="") as f:
                row = [time.time(), int(2 ** s.point[0]), int(s.point[1])]
                for extra in s.point[2:]:    # fused/quant/.../moe dims
                    # Leg knobs are small ints; the capacity-factor
                    # column is fractional — keep it readable either way.
                    row.append(int(extra) if float(extra).is_integer()
                               else f"{extra:g}")
                csv.writer(f).writerow(row + [f"{s.score:.1f}"])
        except OSError as e:
            log.warning("autotune log write failed: %s", e)


def _model_seed(dim: str) -> Optional[bool]:
    """The reference's cost-model leg ordering, consulted when
    ``HVDT_AUTOTUNE_MODEL_SEED`` is on and no measured seed or explicit
    env policy decided a starting leg.  None when the knob is off; the
    cost model (``analysis/costmodel``) is not ported, so any other
    value raises."""
    raw = config.get_str("HVDT_AUTOTUNE_MODEL_SEED").strip()
    if raw.lower() in ("", "0", "off", "false", "no"):
        return None
    raise NotImplementedError(
        f"HVDT_AUTOTUNE_MODEL_SEED={raw!r} needs the static cost model "
        f"(analysis/costmodel), which is not ported yet (ROADMAP Queue 1 "
        f"item 8: control, analysis and the edges); unset it to seed the "
        f"{dim} leg from the environment")


# quant_leg knob encoding (one GP column spanning three legs).
_LEG_VALUES = {"f32": 0.0, "int8": 1.0, "int4": 2.0}


def _env_quant_leg() -> str:
    """The environment's quantized-wire default leg (the quant
    dimension's starting point): HVDT_QUANT → int8,
    HVDT_COMPRESSION=int8|int4 by name; with neither set (and no
    explicit non-quantized compression choice), the cost model may
    order the leg (HVDT_AUTOTUNE_MODEL_SEED — a True verdict starts at
    int8, the conservative quantized leg)."""
    if config.get_bool("HVDT_QUANT"):
        return "int8"
    comp = config.get_str("HVDT_COMPRESSION").strip().lower()
    if comp in ("int8", "int4"):
        return comp
    if comp:
        return "f32"           # explicit non-quantized wire choice wins
    ms = _model_seed("quant")
    return "int8" if ms else "f32"


def _env_quant_wire() -> bool:
    """The environment's quantized-wire default as a bool (any
    quantized leg; the legacy ``quant=`` builder keyword)."""
    return _env_quant_leg() != "f32"


def _env_overlap() -> bool:
    """The environment's overlap-schedule default (the overlap
    dimension's starting leg): HVDT_OVERLAP truthy; unset (not an
    explicit 'off'), the cost model may order the leg
    (HVDT_AUTOTUNE_MODEL_SEED)."""
    from .ops.overlap import enabled

    if enabled():
        return True
    if config.get_str("HVDT_OVERLAP").strip():
        return False           # explicit off wins over the model
    ms = _model_seed("overlap")
    return bool(ms) if ms is not None else False


def _env_zero() -> bool:
    """The environment's replicated-vs-sharded default (the zero
    dimension's starting leg): HVDT_ZERO set, else the MEASURED verdict
    of a bench_allreduce --reduce-scatter sweep named by
    HVDT_AUTOTUNE_ZERO_SEED (rs_ag_speedup_vs_allreduce_at_peak > 1 ⇒
    start sharded) — the policies-are-measured loop, mirroring
    _env_transport."""
    from .ops.zero import enabled as zero_enabled

    try:
        if zero_enabled():
            return True
    except ValueError:
        return False
    seed = config.get_str("HVDT_AUTOTUNE_ZERO_SEED").strip()
    if not seed:
        return False
    import json

    try:
        with open(seed) as fh:
            doc = json.load(fh)
        return float(doc.get("rs_ag_speedup_vs_allreduce_at_peak",
                             0.0)) > 1.0
    except (OSError, ValueError, TypeError) as e:
        log.warning("zero autotune seed %s unreadable: %s", seed, e)
        return False


def _env_transport() -> bool:
    """The environment's flat-vs-hierarchical default (the transport
    dimension's starting leg): HVDT_TRANSPORT set, else the MEASURED
    verdict of a bench_allreduce sweep named by
    HVDT_AUTOTUNE_TRANSPORT_SEED (hierarchical_speedup_vs_flat_at_peak
    > 1 ⇒ start hierarchical) — the policies-are-measured loop."""
    from .transport import enabled

    if enabled():
        return True
    seed = config.get_str("HVDT_AUTOTUNE_TRANSPORT_SEED").strip()
    if not seed:
        ms = _model_seed("transport")
        return bool(ms) if ms is not None else False
    import json

    try:
        with open(seed) as fh:
            doc = json.load(fh)
        return float(doc.get("hierarchical_speedup_vs_flat_at_peak",
                             0.0)) > 1.0
    except (OSError, ValueError, TypeError) as e:
        log.warning("transport autotune seed %s unreadable: %s", seed, e)
        ms = _model_seed("transport")
        return bool(ms) if ms is not None else False


def _env_capacity_factor() -> float:
    """The environment's expert capacity-factor default (the MoE
    dimension's starting leg): an explicitly set
    HVDT_MOE_CAPACITY_FACTOR wins; else the MEASURED verdict of a
    bench.py --moe sweep named by HVDT_AUTOTUNE_MOE_SEED
    (capacity_factor_at_peak); else the cost model may order the leg
    (HVDT_AUTOTUNE_MODEL_SEED — a True 'moe' verdict means the
    quantized dispatch wire wins, so capacity headroom is cheap: start
    at the registry default 1.25; False starts tight at 1.0 to keep
    the expensive f32 dispatch payload minimal)."""
    import os

    if os.environ.get("HVDT_MOE_CAPACITY_FACTOR", "").strip():
        return config.get_float("HVDT_MOE_CAPACITY_FACTOR")
    seed = config.get_str("HVDT_AUTOTUNE_MOE_SEED").strip()
    if seed:
        import json

        try:
            with open(seed) as fh:
                doc = json.load(fh)
            v = float(doc.get("capacity_factor_at_peak", 0.0))
            if v > 0:
                return v
        except (OSError, ValueError, TypeError) as e:
            log.warning("moe autotune seed %s unreadable: %s", seed, e)
    ms = _model_seed("moe")
    if ms is not None:
        return 1.25 if ms else 1.0
    return config.get_float("HVDT_MOE_CAPACITY_FACTOR")


def _env_microbatches() -> int:
    """The environment's 1F1B microbatch-count default (the pipeline
    dimension's starting leg): an explicitly set
    HVDT_PIPELINE_MICROBATCHES wins; else the MEASURED verdict of a
    bench.py --pipeline sweep named by HVDT_AUTOTUNE_PIPELINE_SEED
    (microbatches_at_peak); else the cost model may order the leg
    (HVDT_AUTOTUNE_MODEL_SEED — a True 'pipeline' verdict means the
    tick is bandwidth-dominated, so halving per-tick payload is free
    bubble shrink: start at the high end 16; False starts at the
    registry default 8)."""
    import os

    if os.environ.get("HVDT_PIPELINE_MICROBATCHES", "").strip():
        return max(1, config.get_int("HVDT_PIPELINE_MICROBATCHES"))
    seed = config.get_str("HVDT_AUTOTUNE_PIPELINE_SEED").strip()
    if seed:
        import json

        try:
            with open(seed) as fh:
                doc = json.load(fh)
            v = int(doc.get("microbatches_at_peak", 0))
            if v > 0:
                return v
        except (OSError, ValueError, TypeError) as e:
            log.warning("pipeline autotune seed %s unreadable: %s",
                        seed, e)
    ms = _model_seed("pipeline")
    if ms is not None:
        return 16 if ms else max(1, config.get_int(
            "HVDT_PIPELINE_MICROBATCHES"))
    return max(1, config.get_int("HVDT_PIPELINE_MICROBATCHES"))


class BenchmarkAutotuner:
    """The closed loop that ties :class:`ParameterManager` to a train
    loop::

        tuner = BenchmarkAutotuner(tree_example=grads)
        step = build_step(threshold_bytes=tuner.bucket_bytes)
        for ...:
            t0 = time.perf_counter(); run_n_steps(k)
            if tuner.record(time.perf_counter() - t0, steps=k):
                step = build_step(threshold_bytes=tuner.bucket_bytes)

    ``record`` returns True when the knobs changed: the caller rebuilds
    its step with the new ``bucket_bytes`` (a graphed step is captured
    again; the next sample and the warmup discards absorb the cost).
    When the knobs change, rank 0's choice is broadcast over the process
    group's c10d store (``StoreControlPlane``) and adopted everywhere,
    so every rank builds the same buckets; a world of one uses the local
    plane (no-op).
    """

    def __init__(self, tree_example, steps_per_sample: Optional[int] = None,
                 pm: Optional[ParameterManager] = None,
                 control_plane=None):
        self.pm = pm or ParameterManager(steps_per_sample=steps_per_sample)
        self._grad_bytes = float(sum(
            l.numel() * l.element_size() for l in _tree_leaves(tree_example)
            if hasattr(l, "element_size")))
        self._cp = control_plane
        self._sync_cycle = 0

    @property
    def bucket_bytes(self) -> int:
        return self.pm.bucket_bytes

    @property
    def done(self) -> bool:
        return self.pm.tuning_complete

    def record(self, seconds: float, steps: int = 1) -> bool:
        """Feed ``steps`` steps that took ``seconds`` total; True when the
        knobs changed and the caller should rebuild its step."""
        changed = False
        per = seconds / max(1, steps)
        for _ in range(steps):
            changed = self.pm.record(self._grad_bytes, per) or changed
        if changed:
            self._sync()
        return changed

    def _sync(self) -> None:
        """Adopt rank 0's knob point everywhere (a broadcast over the
        c10d store)."""
        cp = self._cp
        if cp is None:
            from .common import basics
            from .ops.control_plane import (LocalControlPlane,
                                            default_control_plane)

            # Un-initialized framework == single process: nothing to sync.
            self._cp = cp = (default_control_plane()
                             if basics.is_initialized()
                             else LocalControlPlane())
        if cp.size() <= 1:
            return
        self._sync_cycle += 1
        payload = None
        if cp.rank() == 0:
            payload = ",".join(f"{v:.6f}" for v in self.pm._current)
        wire = cp.broadcast(payload, cycle=10_000_000 + self._sync_cycle)
        point = np.array([float(v) for v in wire.split(",")])
        self.pm._current = point
        self.pm._sample = _Sample(point)

    def summary(self) -> str:
        state = "converged" if self.done else "tuning"
        fused = (f" fused_opt={int(self.pm.fused_optimizer)}"
                 if self.pm.tune_fused else "")
        quant = (f" wire={self.pm.quant_leg}"
                 if self.pm.tune_quant else "")
        ovl = (f" schedule={'overlap' if self.pm.overlap_schedule else 'mono'}"
               if self.pm.tune_overlap else "")
        tr = (f" transport={'hier' if self.pm.transport_policy else 'flat'}"
              if self.pm.tune_transport else "")
        zr = (f" zero={'sharded' if self.pm.zero_sharding else 'repl'}"
              if self.pm.tune_zero else "")
        moe = (f" capacity={self.pm.capacity_factor:g}"
               if self.pm.tune_moe else "")
        pipe = (f" microbatches={self.pm.num_microbatches}"
                if self.pm.tune_pipeline else "")
        return (f"{state}: bucket={self.pm.bucket_bytes // 2**20} MiB "
                f"overlap={self.pm.overlap_buckets}"
                f"{fused}{quant}{ovl}{tr}{zr}{moe}{pipe} "
                f"({self.pm._samples_done} samples)")


def _tree_leaves(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


class AutotunedStep:
    """Transparent env-driven engagement of the closed tuning loop: the
    reference's autotuner engages for any training run when
    ``HOROVOD_AUTOTUNE=1`` is set.  The engagement point is a step
    wrapper owning the (re)build::

        step = hvd.autotune.autotuned_step(build_step)   # always
        ...
        loss = step(model, opt, images, labels)

    With ``HVDT_AUTOTUNE`` unset this is a passthrough (``builder(None)``
    once, direct dispatch).  With ``HVDT_AUTOTUNE=1`` the wrapper times
    steps_per_sample-step regions (each closed by a host fetch of the
    smallest output tensor, which waits for the device), feeds
    :class:`BenchmarkAutotuner`, rebuilds the step through
    ``builder(new_threshold_bytes, **legs)`` when the knobs move, syncs
    rank 0's choice, and discards the first region after every rebuild
    (a fresh ``donated_step`` captures in it).

    With ``HVDT_AUTOTUNE_FUSED_OPTIMIZER=1`` the search space gains a
    fused-vs-unfused optimizer dimension (ops/optim_kernels): a builder
    that accepts a ``fused`` keyword is rebuilt as
    ``builder(threshold_bytes, fused=bool)`` at each knob change, so the
    GP prices the update-side kernels jointly with the comm bucketing.
    Builders without the keyword keep the old call shape.

    With ``HVDT_AUTOTUNE_QUANT=1`` the space likewise gains a
    quantized-*wire* leg dimension (quant/; f32/int8/int4):
    builders accepting a ``quant`` keyword are rebuilt as
    ``builder(threshold_bytes, quant=bool)`` (any quantized leg →
    True); builders accepting ``quant_leg`` additionally receive the
    leg by name (``quant_leg="f32"|"int8"|"int4"``) and can pick the
    matching ``Compression`` + ``with_error_feedback(wire=...)``.
    Hot-swappable mid-run because every wire leg keeps one optimizer
    state tree — the error-feedback residual is leg-independent f32
    (``quant.with_error_feedback(enabled=..., wire=...)``).

    With ``HVDT_AUTOTUNE_OVERLAP=1`` the space gains an
    overlap-schedule on/off dimension (ops/overlap.py): builders
    accepting an ``overlap`` keyword are rebuilt as
    ``builder(threshold_bytes, overlap=bool)`` — hot-swappable mid-run
    because the schedule changes how the exchange is issued, never
    optimizer state, so both legs keep one state tree.

    With ``HVDT_AUTOTUNE_TRANSPORT=1`` the space gains a
    flat-vs-hierarchical transport dimension (transport/):
    builders accepting a ``transport`` keyword are rebuilt as
    ``builder(threshold_bytes, transport=bool)`` — same
    one-state-tree hot-swap contract (the policy changes the
    collectives, never state), with the STARTING
    leg seeded from ``HVDT_TRANSPORT`` or the measured
    ``HVDT_AUTOTUNE_TRANSPORT_SEED`` bench verdict.

    With ``HVDT_AUTOTUNE_ZERO=1`` the space gains a
    replicated-vs-ZeRO-sharded dimension (ops/zero.py): builders
    accepting a ``zero`` keyword are rebuilt as
    ``builder(threshold_bytes, zero=bool)`` — hot-swappable because
    both legs keep ONE sharded state tree (the replicated leg is the
    allreduce + own-shard-slice wire, ``zero_transform(...,
    rs_wire=False)``, ``DistributedOptimizer``'s ``set_rs_wire``), with
    the
    STARTING leg seeded from ``HVDT_ZERO`` or the measured
    ``HVDT_AUTOTUNE_ZERO_SEED`` bench_allreduce --reduce-scatter
    verdict.

    With ``HVDT_AUTOTUNE_MOE=1`` the space gains an expert
    capacity-factor dimension (parallel/moe.py): builders accepting a
    ``capacity_factor`` keyword are rebuilt as
    ``builder(threshold_bytes, capacity_factor=float)`` — dispatch
    payload vs dropped-token fraction, priced jointly with the wire
    legs; hot-swappable because capacity changes the dispatch layout
    (a rebuild), never optimizer state.  Starting leg: explicit
    ``HVDT_MOE_CAPACITY_FACTOR``, the measured
    ``HVDT_AUTOTUNE_MOE_SEED`` bench verdict, or the cost model's
    a2a-wire ordering (``HVDT_AUTOTUNE_MODEL_SEED``).

    With ``HVDT_AUTOTUNE_PIPELINE=1`` the space gains a 1F1B
    microbatch-count dimension (parallel/pipeline.py): builders
    accepting a ``microbatches`` keyword are rebuilt as
    ``builder(threshold_bytes, microbatches=int)`` — bubble fraction
    vs per-tick ppermute payload; hot-swappable because the clock
    changes the schedule, never state.  Starting leg: explicit
    ``HVDT_PIPELINE_MICROBATCHES``, the measured
    ``HVDT_AUTOTUNE_PIPELINE_SEED`` bench verdict, or the cost model's
    ppermute ordering.

    Args:
      builder: ``builder(threshold_bytes | None) -> step_callable``
        (optionally also accepting ``fused=bool``).
      tree_example: gradient-sized pytree for the bytes/sec score; when
        None, the first positional arg of the first call is used.
      enabled: force on/off; None (default) reads ``HVDT_AUTOTUNE``.
    """

    def __init__(self, builder, tree_example=None, *,
                 enabled: Optional[bool] = None,
                 steps_per_sample: Optional[int] = None,
                 control_plane=None):
        import inspect

        if enabled is None:
            enabled = config.get_bool("HVDT_AUTOTUNE")
        self.enabled = bool(enabled)
        self._builder = builder
        try:
            sig = inspect.signature(builder).parameters
            var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.values())
            self._accepts_fused = "fused" in sig or var_kw
            self._accepts_quant = "quant" in sig or var_kw
            self._accepts_quant_leg = "quant_leg" in sig or var_kw
            self._accepts_overlap = "overlap" in sig or var_kw
            self._accepts_transport = "transport" in sig or var_kw
            self._accepts_zero = "zero" in sig or var_kw
            self._accepts_capacity = "capacity_factor" in sig or var_kw
            self._accepts_microbatches = "microbatches" in sig or var_kw
        except (TypeError, ValueError):
            self._accepts_fused = False
            self._accepts_quant = False
            self._accepts_quant_leg = False
            self._accepts_overlap = False
            self._accepts_transport = False
            self._accepts_zero = False
            self._accepts_capacity = False
            self._accepts_microbatches = False
        # Pin every tuned A/B dimension's starting leg at build 0 so the
        # opt-state structure established before tuning matches every
        # later rebuild (both fused legs keep one state tree —
        # ops/optim_kernels; both wire legs too —
        # quant.with_error_feedback(enabled=...)).
        build_kw = {}
        if (self.enabled and self._accepts_fused
                and config.get_bool("HVDT_AUTOTUNE_FUSED_OPTIMIZER")):
            build_kw["fused"] = config.get_bool("HVDT_FUSED_OPTIMIZER")
        if (self.enabled and self._accepts_quant
                and config.get_bool("HVDT_AUTOTUNE_QUANT")):
            build_kw["quant"] = _env_quant_wire()
        if (self.enabled and self._accepts_quant_leg
                and config.get_bool("HVDT_AUTOTUNE_QUANT")):
            build_kw["quant_leg"] = _env_quant_leg()
        if (self.enabled and self._accepts_overlap
                and config.get_bool("HVDT_AUTOTUNE_OVERLAP")):
            build_kw["overlap"] = _env_overlap()
        if (self.enabled and self._accepts_transport
                and config.get_bool("HVDT_AUTOTUNE_TRANSPORT")):
            build_kw["transport"] = _env_transport()
        if (self.enabled and self._accepts_zero
                and config.get_bool("HVDT_AUTOTUNE_ZERO")):
            build_kw["zero"] = _env_zero()
        if (self.enabled and self._accepts_capacity
                and config.get_bool("HVDT_AUTOTUNE_MOE")):
            build_kw["capacity_factor"] = _env_capacity_factor()
        if (self.enabled and self._accepts_microbatches
                and config.get_bool("HVDT_AUTOTUNE_PIPELINE")):
            build_kw["microbatches"] = _env_microbatches()
        self._step = builder(None, **build_kw)
        self._tree_example = tree_example
        self._steps_per_sample = steps_per_sample
        self._cp = control_plane
        self._tuner: Optional[BenchmarkAutotuner] = None
        self._t0: Optional[float] = None
        self._pending = 0
        self._skip_sample = False
        # Controller seam (the reference's control/ plane, not ported):
        # leg overrides queued by apply_leg, adopted at the next
        # __call__ boundary and merged LAST into every later rebuild so
        # the tuner doesn't stomp them.
        self._pending_legs: Dict[str, Any] = {}
        self._leg_overrides: Dict[str, Any] = {}
        self._override_threshold: Optional[int] = None

    @property
    def autotuner(self) -> Optional[BenchmarkAutotuner]:
        return self._tuner

    @property
    def bucket_bytes(self) -> Optional[int]:
        return self._tuner.bucket_bytes if self._tuner else None

    def summary(self) -> str:
        if not self.enabled:
            return "autotune disabled (HVDT_AUTOTUNE not set)"
        return self._tuner.summary() if self._tuner else "no samples yet"

    def _rebuild(self):
        """Rebuild at the tuner's current knob point (fused/quant
        dimensions forwarded only when both the tuner and the builder
        carry them).  Controller leg overrides merge last — an applied
        policy decision survives the tuner's own rebuilds."""
        pm = self._tuner.pm
        kw = {}
        if pm.tune_fused and self._accepts_fused:
            kw["fused"] = pm.fused_optimizer
        if pm.tune_quant and self._accepts_quant:
            kw["quant"] = pm.quant_wire
        if pm.tune_quant and self._accepts_quant_leg:
            kw["quant_leg"] = pm.quant_leg
        if pm.tune_overlap and self._accepts_overlap:
            kw["overlap"] = pm.overlap_schedule
        if pm.tune_transport and self._accepts_transport:
            kw["transport"] = pm.transport_policy
        if pm.tune_zero and self._accepts_zero:
            kw["zero"] = pm.zero_sharding
        if pm.tune_moe and self._accepts_capacity:
            kw["capacity_factor"] = pm.capacity_factor
        if pm.tune_pipeline and self._accepts_microbatches:
            kw["microbatches"] = pm.num_microbatches
        kw.update(self._filtered_overrides())
        threshold = (self._override_threshold
                     if self._override_threshold is not None
                     else self._tuner.bucket_bytes)
        return self._builder(threshold, **kw)

    # -- controller seam ----------------------------------------------------

    _LEG_ACCEPTS = {"fused": "_accepts_fused", "quant": "_accepts_quant",
                    "quant_leg": "_accepts_quant_leg",
                    "overlap": "_accepts_overlap",
                    "transport": "_accepts_transport",
                    "zero": "_accepts_zero",
                    "capacity_factor": "_accepts_capacity",
                    "microbatches": "_accepts_microbatches"}

    def apply_leg(self, **legs: Any) -> None:
        """Queue a policy-controller leg override, adopted at the NEXT
        ``__call__`` — never mid-step.  Accepts the builder leg
        keywords (``transport=bool``, ``overlap=bool``, ``zero=bool``,
        ``quant=bool``, ``quant_leg=str``, ``fused=bool``) plus
        ``threshold_bytes=int`` for a bucket retune.  Adoption is the
        same state-compatible rebuild the tuner performs: one optimizer
        state tree, a rebuild only.  Works with
        the tuner off (``HVDT_AUTOTUNE`` unset) — the controller can
        steer an untuned run."""
        self._pending_legs.update(legs)

    def _filtered_overrides(self) -> Dict[str, Any]:
        return {k: v for k, v in self._leg_overrides.items()
                if getattr(self, self._LEG_ACCEPTS.get(k, ""), False)}

    def _adopt_legs(self) -> None:
        pending, self._pending_legs = self._pending_legs, {}
        if "threshold_bytes" in pending:
            self._override_threshold = int(pending.pop("threshold_bytes"))
        self._leg_overrides.update(pending)
        self._step = (self._rebuild() if self._tuner is not None
                      else self._builder(self._override_threshold,
                                         **self._filtered_overrides()))
        if self._tuner is not None:
            # The adopting region includes a rebuild: discard
            # its sample so compile time can't poison the tuner score.
            self._skip_sample = True
        log.info("controller leg adopted: %s%s", pending,
                 (f" threshold={self._override_threshold}"
                  if self._override_threshold is not None else ""))

    @staticmethod
    def _fetch(out) -> None:
        """Close the timed region with a device->host transfer that
        data-depends on the step output (its smallest tensor leaf: the
        loss)."""
        import torch

        leaves = [l for l in _tree_leaves(out) if isinstance(l, torch.Tensor)]
        if leaves:
            min(leaves, key=lambda l: l.numel()).detach().cpu()

    def __call__(self, *args, **kwargs):
        if self._pending_legs:
            self._adopt_legs()
        if not self.enabled:
            return self._step(*args, **kwargs)
        if self._tuner is None:
            tree = (self._tree_example if self._tree_example is not None
                    else (args[0] if args else ()))
            self._tuner = BenchmarkAutotuner(
                tree_example=tree, steps_per_sample=self._steps_per_sample,
                control_plane=self._cp)
        if self._t0 is None:
            self._t0 = time.perf_counter()
        out = self._step(*args, **kwargs)
        self._pending += 1
        if self._pending >= self._tuner.pm.steps_per_sample:
            self._fetch(out)
            dt = time.perf_counter() - self._t0
            if self._skip_sample:
                # Region included a rebuild: a capture would poison the
                # new point's score — discard, measure the next region.
                self._skip_sample = False
            elif self._tuner.record(dt, steps=self._pending):
                self._step = self._rebuild()
                self._skip_sample = True
                log.info("autotune applied: bucket=%d MiB",
                         self._tuner.bucket_bytes // 2 ** 20)
            self._pending = 0
            self._t0 = None
        return out


def autotuned_step(builder, tree_example=None, *,
                   enabled: Optional[bool] = None,
                   steps_per_sample: Optional[int] = None,
                   control_plane=None) -> AutotunedStep:
    """See :class:`AutotunedStep` — the ``HVDT_AUTOTUNE`` engagement."""
    return AutotunedStep(builder, tree_example, enabled=enabled,
                         steps_per_sample=steps_per_sample,
                         control_plane=control_plane)
