"""Env-var knob reader — the knobs this package reads.

A copy of the reader in the JAX package's ``common/config.py`` holding
only the knobs the PyTorch port consumes.  Names, meanings and
defaults are the same as there, so one environment configures either
package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

__all__ = ["Knob", "KNOBS", "get", "get_bool", "get_int", "get_float",
           "get_str"]


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            return self.parser(raw)
        except (ValueError, TypeError):
            return self.default


KNOBS: Dict[str, Knob] = {
    k.name: k
    for k in [
        Knob("HVDT_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
             "Tensor-fusion bucket size in bytes for fused gradient "
             "allreduce (64 MiB)."),
        Knob("HVDT_FUSED_CONV1X1", False, _parse_bool,
             "Route eligible ResNet 1x1 conv+BN(+ReLU) blocks through the "
             "fused conv kernels (ops/conv_fused.py): train mode emits the "
             "conv output and batch-stat partials in one pass, eval mode "
             "fuses the folded affine into the matmul epilogue.  Default "
             "off, as in the JAX package.  Eligibility: 1x1, stride 1, "
             "Cin % 128 == 0 and Cout % 128 == 0."),
        Knob("HVDT_COMPRESSION", "", str,
             "Gradient wire compressor by name: none|bf16|fp16|int8|int4 "
             "(empty = none).  Consumed by init() and by "
             "DistributedOptimizer / allreduce_gradients when "
             "compression= is unset; unknown names raise with the valid "
             "list."),
        Knob("HVDT_QUANT", False, _parse_bool,
             "Shorthand for HVDT_COMPRESSION=int8 (wins over it): route "
             "gradient collectives over the block-scaled int8 wire "
             "(quant/collectives two-stage quantized allreduce).  Pair "
             "with quant.with_error_feedback."),
        Knob("HVDT_QUANT_BLOCK", 256, int,
             "Block size (elements) for int8/int4 wire quantization: one "
             "f32 absmax scale per block (256 = 1.6% scale overhead).  "
             "The CUDA kernels take any block (any even block for int4)."),
        Knob("HVDT_QUANT_KERNELS", "auto", str,
             "Quantize/dequantize route: auto (the CUDA kernel for a CUDA "
             "tensor, the plain PyTorch version for a CPU tensor), on (the "
             "kernel; a CPU tensor raises), off (the plain version "
             "everywhere, an explicit opt-out)."),
        Knob("HVDT_FLASH_ATTENTION", "auto", str,
             "Flash-attention kernel for the transformer's attention: auto "
             "(CUDA tensors only, when the f32 score tensor batch x heads "
             "x L x L would reach 4 GiB), on (whenever the sequence "
             "tiles; the plain version for CPU tensors), off."),
        Knob("HVDT_FLASH_BWD", "xla", str,
             "flash_attention backward: xla (the reference's blockwise "
             "recompute, plain PyTorch) or kernel (flash_grad_block: the "
             "dQ and dK/dV kernels).  Read each time a backward runs."),
        Knob("HVDT_FLASH_SMALLSEQ", "auto", str,
             "Whole-sequence attention kernels (flash_attention_smallseq, "
             "the forward and backward kernels of csrc/flash_smallseq.cu) "
             "for the transformer at seq <= 1024: auto (disengaged until a "
             "measured threshold is set, as in the reference), on (whenever "
             "seq % 128 == 0 and seq <= 1024; the plain versions for CPU "
             "tensors), off.  HVDT_FLASH_ATTENTION=off overrides to off; "
             "HVDT_FLASH_ATTENTION=on forces the streaming kernel."),
        Knob("HVDT_FLASH_SMALLSEQ_HB", 8, int,
             "heads_per_block for the smallseq attention kernels (clamped "
             "to divide the head count and to whole GQA groups).  On the "
             "card it shapes only the plain version's loop over heads; "
             "auto's program count reads it."),
        Knob("HVDT_RING_PALLAS", False, _parse_bool,
             "Run ring attention's per-step block update and backward "
             "through the flash kernels (#9 flash_block_update forward, "
             "#10/#11 flash_grad_block backward) where legal; read when "
             "ring_attention is called with use_pallas=None.  On a CUDA "
             "tensor the kernels are that default anyway wherever they "
             "take the operands, and the knob makes them required."),
        Knob("HVDT_REMAT", "", str,
             "Activation rematerialization for the transformer block: "
             "'none'/'' (default) saves all activations; 'full' saves "
             "only block inputs (torch.utils.checkpoint per layer); "
             "'dots' is not ported yet and raises."),
        Knob("HVDT_FP8", "off", str,
             "fp8 (e4m3) compute path: off (default) or matmul (the "
             "transformer projections through quant/fp8.py: "
             "torch._scaled_mm on the card).  Unknown values raise with "
             "the valid list."),
        Knob("HVDT_OVERLAP", "", str,
             "Overlapped gradient exchange (ops/overlap.py): 'on' makes "
             "DistributedOptimizer issue each bucket's collective from "
             "gradient hooks, in reverse-topological order, on a "
             "communication stream while the backward runs; unset/'off' "
             "(default) keeps the exchange in step()."),
        Knob("HVDT_XLA_LATENCY_HIDING", "auto", str,
             "The reference's XLA latency-hiding flags: auto, on, off "
             "(validated; the port sets nothing, its overlap comes from "
             "HVDT_OVERLAP's hooks)."),
        Knob("HVDT_TRANSPORT", "", str,
             "Per-mesh-axis transport policy (horovod_tpu_torch/"
             "transport): comma entries axis:algorithm:wire[:threshold] "
             "with axis in {ici,dcn,dp,pp,fsdp,ep,sp,tp}, algorithm in "
             "{ring,tree,2d_ring}, wire in {f32,bf16,fp16,int8,int4} "
             "(int8/int4 on dcn only), threshold digits[K|M|G]; or "
             "'auto'.  Unset (default) keeps the flat exchange; unknown "
             "vocabulary raises at init()."),
        Knob("HVDT_ZERO", "", str,
             "ZeRO-style state-sharding stage (ops/zero.py): 'grads' swaps "
             "the fused allreduce for an explicit reduce-scatter + "
             "allgather split (same wire bytes; any torch.optim "
             "optimizer); 'states' reduce-scatters gradients and runs the "
             "fused update (#1/#2) on each rank's 1/n shard of the "
             "moments, allgathering only the parameter deltas (optimizer "
             "memory shrinks ~n x; requires fused_adam/fused_sgd); "
             "'params' additionally keeps the parameters sharded between "
             "steps (gather_params() before the forward).  Unset/'off' "
             "(default) keeps the replicated path as the identical "
             "objects; unknown stages fail init() with the valid list."),
        Knob("HVDT_ASYNC_CKPT", False, _parse_bool,
             "Asynchronous checkpointing: CheckpointManager.save_async "
             "takes a device->host snapshot at the commit point and hands "
             "it to a background writer thread (queue depth 1, a newer "
             "snapshot supersedes a queued older one); LAST_GOOD advances "
             "only after the manifest write + fsync.  Unset (default): "
             "save_async IS the synchronous save."),
        Knob("HVDT_CKPT_SNAPSHOT_BUDGET_S", 1.0, float,
             "Stall budget for the commit-point device->host checkpoint "
             "snapshot (the only part of an async save the step loop "
             "pays).  Snapshots are timed into hvdt_ckpt_snapshot_seconds; "
             "one over the budget logs a warning and increments "
             "hvdt_ckpt_snapshot_over_budget_total."),
        Knob("HVDT_AUTOTUNE", False, _parse_bool,
             "Enable Bayesian autotuning of the fusion threshold and the "
             "knob dimensions below (autotune.AutotunedStep)."),
        Knob("HVDT_AUTOTUNE_LOG", "", str,
             "CSV log file for autotune samples."),
        Knob("HVDT_AUTOTUNE_WARMUP_SAMPLES", 3, int,
             "Autotune warmup discard count."),
        Knob("HVDT_AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
             "Steps per autotune sample."),
        Knob("HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
             "Max BO samples."),
        Knob("HVDT_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8, float,
             "GP noise alpha."),
        Knob("HVDT_AUTOTUNE_FUSED_OPTIMIZER", False, _parse_bool,
             "Add a fused-vs-unfused optimizer dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "fused=... at each knob change.  Starting point comes from "
             "HVDT_FUSED_OPTIMIZER."),
        Knob("HVDT_FUSED_OPTIMIZER", False, _parse_bool,
             "The fused optimizer kernels (fused_adam/fused_sgd, #1/#2) "
             "as the default of bench legs that read it; the autotuner's "
             "fused dimension starts here."),
        Knob("HVDT_AUTOTUNE_QUANT", False, _parse_bool,
             "Add a quantized-wire leg dimension (f32/int8/int4) to the "
             "autotune search space; the step builder is rebuilt with "
             "quant=.../quant_leg=... at each knob change.  Starting "
             "point comes from HVDT_QUANT / HVDT_COMPRESSION."),
        Knob("HVDT_AUTOTUNE_OVERLAP", False, _parse_bool,
             "Add an overlap-schedule on/off dimension to the autotune "
             "search space; the step builder is rebuilt with overlap=... "
             "at each knob change (both legs keep one optimizer state).  "
             "Starting point comes from HVDT_OVERLAP."),
        Knob("HVDT_AUTOTUNE_TRANSPORT", False, _parse_bool,
             "Add a flat-vs-hierarchical transport dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "transport=... at each knob change.  Starting point: "
             "HVDT_TRANSPORT set, or the measured "
             "HVDT_AUTOTUNE_TRANSPORT_SEED verdict."),
        Knob("HVDT_AUTOTUNE_TRANSPORT_SEED", "", str,
             "Path to a bench_allreduce --json-out file; when its measured "
             "hierarchical_speedup_vs_flat_at_peak exceeds 1.0 the "
             "transport dimension starts on the hierarchical leg."),
        Knob("HVDT_AUTOTUNE_ZERO", False, _parse_bool,
             "Add a replicated-vs-ZeRO-sharded dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "zero=... at each knob change, hot-swappable because both "
             "legs keep ONE sharded state tree (the replicated leg "
             "exchanges via allreduce and slices its shard).  Starting "
             "point: HVDT_ZERO set, or the measured "
             "HVDT_AUTOTUNE_ZERO_SEED verdict."),
        Knob("HVDT_AUTOTUNE_ZERO_SEED", "", str,
             "Path to a bench_allreduce --reduce-scatter --json-out file; "
             "when its measured rs_ag_speedup_vs_allreduce_at_peak exceeds "
             "1.0 the zero dimension starts on the sharded leg."),
        Knob("HVDT_PP", 1, int,
             "Pipeline-parallel extent of the pod mesh "
             "(parallel.mesh.pod_mesh_spec): carves whole pod groups into "
             "1F1B stages on the DCN tier.  Must divide the pod count; 1 "
             "(default) keeps the (dcn, ici) 2-axis mesh."),
        Knob("HVDT_EP", 1, int,
             "Expert-parallel extent of the pod mesh "
             "(parallel.mesh.pod_mesh_spec): carves ranks inside each pod "
             "into expert ranks on the ICI tier.  Must divide the pod "
             "size; 1 (default) keeps the 2-axis mesh."),
        Knob("HVDT_MOE_CAPACITY_FACTOR", 1.25, float,
             "Default expert capacity factor for "
             "parallel.moe.moe_dispatch_combine: per-expert slots = "
             "ceil(tokens * top_k / experts * factor).  Tokens over "
             "capacity are dropped (residual passthrough); "
             "hvdt_moe_dropped_fraction reports the realized drop rate."),
        Knob("HVDT_MOE_TOPK", 1, int,
             "Default experts-per-token for "
             "parallel.moe.moe_dispatch_combine (gates renormalized "
             "over the chosen k; 1 = switch routing).  Primary choices "
             "claim capacity before secondary ones."),
        Knob("HVDT_PEAK_FLOPS", 1e12, float,
             "Nominal peak FLOP/s for parallel.pipeline."
             "report_pipeline_mfu (per-chip peak x chips).  On the CPU "
             "sim any consistent value works — MFU is a ratio; the "
             "hvdt_pipeline_mfu gauge carries the result."),
        Knob("HVDT_PIPELINE_MICROBATCHES", 8, int,
             "Default 1F1B microbatch count (the pipeline autotune "
             "dimension's starting point; bench.py --pipeline default). "
             "More microbatches shrink the bubble fraction "
             "(p-1)/(m+p-1) at the cost of smaller per-tick payloads."),
        Knob("HVDT_AUTOTUNE_MOE", False, _parse_bool,
             "Add an expert capacity-factor dimension to the autotune "
             "search space; builders accepting capacity_factor= are "
             "rebuilt with it at each knob change."),
        Knob("HVDT_AUTOTUNE_MOE_SEED", "", str,
             "Path to a bench --moe --json-out file; its measured "
             "capacity_factor_at_peak becomes the MoE dimension's "
             "starting point."),
        Knob("HVDT_AUTOTUNE_PIPELINE", False, _parse_bool,
             "Add a 1F1B microbatch-count dimension to the autotune "
             "search space; builders accepting microbatches= are "
             "rebuilt with it at each knob change."),
        Knob("HVDT_AUTOTUNE_PIPELINE_SEED", "", str,
             "Path to a bench --pipeline --json-out file; its measured "
             "microbatches_at_peak becomes the pipeline dimension's "
             "starting point."),
        Knob("HVDT_AUTOTUNE_MODEL_SEED", "", str,
             "Let autotune consult the static cost model for its "
             "starting legs.  The cost model (analysis/costmodel) is not "
             "ported yet: any value but off raises NotImplementedError "
             "when a starting leg is chosen."),
        Knob("HVDT_TELEMETRY", False, _parse_bool,
             "Enable the telemetry subsystem (horovod_tpu_torch/telemetry): "
             "per-collective bytes/latency metrics, step stats "
             "(examples/s, MFU, goodput), straggler detection, and the "
             "per-worker /metrics HTTP exporter (started by hvd.init()).  "
             "Off (default) installs no wrapper object on the hot paths "
             "(telemetry.instrument.get_recorder() is None)."),
        Knob("HVDT_METRICS_PORT", 9090, int,
             "Base port for the per-worker /metrics + /healthz exporter; "
             "each worker binds base + local_rank (0 = ephemeral port).  "
             "A taken slot falls back to ephemeral with a logged warning."),
        Knob("HVDT_STRAGGLER_WINDOW", 64, int,
             "Steps between cross-rank step-duration allgathers for "
             "straggler detection (telemetry/straggler.py).  0 disables "
             "the cross-rank check."),
        Knob("HVDT_STRAGGLER_THRESHOLD", 2.0, float,
             "A rank is flagged as a straggler when its mean step time "
             "over the last window exceeds this multiple of the median."),
        Knob("HVDT_TELEMETRY_PUBLISH_S", 30.0, float,
             "Seconds between worker snapshot publishes to the rendezvous "
             "KV (/telemetry/<rank>) for driver-side aggregation; only "
             "active under the elastic launcher.  0 disables publishing."),
        Knob("HVDT_HISTORY", False, _parse_bool,
             "Keep bounded per-metric time series (telemetry/history.py: "
             "step time, examples/s, MFU, goodput fraction, per-axis wire "
             "bytes), served as /timeseries on the per-worker exporter, "
             "published in the KV telemetry snapshot for driver-side "
             "step-aligned roll-ups, and fed to the windowed anomaly "
             "detectors.  Requires HVDT_TELEMETRY.  Off (default) = zero "
             "overhead (telemetry.history.get_history() is None)."),
        Knob("HVDT_HISTORY_WINDOW", 512, int,
             "Max samples retained per time series (ring buffer)."),
        Knob("HVDT_HISTORY_SAMPLE_S", 1.0, float,
             "Minimum seconds between time-series samples (steps arriving "
             "faster are coalesced into one sample carrying their mean "
             "step time).  0 = sample every observed step."),
        Knob("HVDT_EVENT_LOG", "", str,
             "Path of the structured JSONL anomaly event log "
             "(telemetry/anomaly.py): each detector firing appends one "
             "JSON line; the elastic driver writes its cluster-scoped "
             "events to the same file.  Empty (default) = off "
             "(telemetry.anomaly.get_event_log() is None)."),
        Knob("HVDT_EVENT_LOG_MAX_BYTES", 0, int,
             "Size bound for the HVDT_EVENT_LOG file: an append that "
             "would pass it rotates the file to <path>.1 (keep-1).  0 "
             "(default) = unbounded."),
        Knob("HVDT_TRACE_DIR", "", str,
             "Enable distributed span tracing (telemetry/trace.py) and "
             "write per-rank Chrome-trace dumps (trace_rank<N>.json) and "
             "desync reports into this directory; under the elastic "
             "launcher the driver also merges the per-rank dumps from the "
             "rendezvous KV into trace_merged.json (rank as pid).  Empty "
             "(default) = off (telemetry.trace.get_tracer() is None)."),
        Knob("HVDT_TRACE_BUFFER", 65536, int,
             "Max spans retained per rank by the trace buffer (ring)."),
        Knob("HVDT_FLIGHT_RECORDER", False, _parse_bool,
             "Enable the collective flight recorder "
             "(telemetry/flight_recorder.py): a ring of the last N "
             "collective events per rank, dumped on stall-abort (with a "
             "cross-rank desync report), on preemption, and on demand "
             "via the exporter's /flightrecorder endpoint.  Off (default) "
             "= zero overhead (get_flight_recorder() is None)."),
        Knob("HVDT_FLIGHT_RECORDER_EVENTS", 256, int,
             "Ring capacity (events) of the collective flight recorder."),
        Knob("HVDT_COMPILATION_CACHE", "", str,
             "Directory for what the port compiles at run time "
             "(step_pipeline.enable_compilation_cache: the torch inductor "
             "and Triton caches, for callers who torch.compile their own "
             "step).  Empty/off = disabled."),
        Knob("HVDT_COMPILATION_CACHE_MIN_COMPILE_SECS", 1.0, float,
             "The reference's filter of cheap XLA compilations.  Accepted "
             "and without effect in the port: torch's caches keep every "
             "entry."),
        Knob("HVDT_CYCLE_TIME", 0.0, float,
             "Background-loop cycle time in ms for the eager path. 0 = run "
             "as fast as possible (with an idle back-off of up to 2 ms)."),
        Knob("HVDT_BATCH_COLLECTIVES", True, _parse_bool,
             "Pack multiple same-dtype tensors into one fused collective."),
        Knob("HVDT_CACHE_CAPACITY", 1024, int,
             "Response-cache capacity (negotiated-collective descriptors)."),
        Knob("HVDT_TIMELINE", "", str,
             "Write per-tensor Chrome-tracing timeline JSON to this path "
             "(timeline.py; started with the eager controller)."),
        Knob("HVDT_TIMELINE_MARK_CYCLES", False, _parse_bool,
             "Mark background-loop cycles in the timeline."),
        Knob("HVDT_STALL_CHECK_DISABLE", False, _parse_bool,
             "Disable stall inspector."),
        Knob("HVDT_STALL_CHECK_TIME_SECONDS", 60, int,
             "Warn when a tensor is ready on some-but-not-all ranks this "
             "long."),
        Knob("HVDT_STALL_SHUTDOWN_TIME_SECONDS", 0, int,
             "Log an error, once, when a tensor has stalled this long "
             "(0 = never).  Logs only: HVDT_STALL_ABORT_TIME_SECONDS is "
             "what fails a stalled op."),
        Knob("HVDT_STALL_ABORT_TIME_SECONDS", 0, int,
             "Stall-escalation abort rung (resilience/escalation.py): past "
             "this age the coordinator aborts the stalled negotiation with "
             "an error response, so waiters raise HorovodInternalError "
             "instead of hanging forever.  0 = disabled."),
        Knob("HVDT_STALL_RESET_TIME_SECONDS", 0, int,
             "Stall-escalation reset rung: past this age a worker "
             "additionally publishes READY to the elastic driver's "
             "registry, requesting a full re-rendezvous.  0 = disabled."),
        Knob("HVDT_FAULT_PLAN", "", str,
             "Declarative chaos-testing fault plan (resilience/faults.py), "
             "e.g. 'crash@step=12:rank=1,hang@step=30:secs=20,"
             "corrupt_ckpt@step=40,kv_drop@p=0.1'.  Empty (default) "
             "compiles every injection point to a no-op."),
        Knob("HVDT_FAULT_SEED", 0, int,
             "RNG seed for probabilistic fault-plan entries (kv_drop@p=...) "
             "so chaos runs are reproducible."),
        Knob("HVDT_FAULT_JOURNAL", "", str,
             "Path prefix for the fired-fault journal (per rank: "
             "<path>.rank<N>).  Elastic recovery respawns processes; the "
             "journal carries each fault's fired count across restarts so "
             "'times' bounds fires per JOB, not per process life.  Empty "
             "= per-process counting."),
        Knob("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", 0.0, float,
             "Blacklist cooldown for failed hosts in elastic discovery: 0 "
             "(default) = permanent blacklist; >0 = the host re-enters "
             "discovery after the cooldown, doubling per repeated failure "
             "(capped 8x).  Set for single-host chaos runs, where a "
             "permanent blacklist would strand the job."),
        Knob("HVDT_POD", "", str,
             "Pod id this worker belongs to.  Set per slot by the elastic "
             "launcher from the discovery script's 'host[:slots][@pod]' "
             "column (or the host itself); read by pod-scoped fault-plan "
             "entries (pod_crash/pod_partition)."),
        Knob("HVDT_POD_SIZE", 0, int,
             "Slots per pod.  Driver side: chunk undeclared discovery "
             "hosts (in order) into pods of this many slots — the "
             "alternative to the @pod discovery column.  0 = per-host "
             "pods (the flat semantics)."),
        Knob("HVDT_POD_EXIT_WINDOW_S", 10.0, float,
             "Pod exit-correlation window: failure exits of one pod's "
             "ranks within this many seconds collapse into ONE pod-"
             "removal event — one blacklist entry, one cooldown clock."),
        Knob("HVDT_POD_DRAIN_GRACE_S", 60.0, float,
             "How long a preemption-drained pod stays excluded from pod "
             "assignment while waiting for the platform to reclaim its "
             "hosts; after the grace it becomes placeable again."),
        Knob("HVDT_POD_STRAGGLER_EVICT", 0, int,
             "Pod-straggler eviction rung: a pod whose median step time "
             "exceeds HVDT_STRAGGLER_THRESHOLD x the cross-pod median for "
             "this many consecutive telemetry windows is evicted "
             "(cooldown blacklist + pod-granular resize down).  0 = "
             "disabled.  Needs HVDT_TELEMETRY on the workers (the driver "
             "aggregates their KV snapshots)."),
        Knob("HVDT_PEER_STORE", False, _parse_bool,
             "In-memory peer-replicated snapshot tier "
             "(resilience/peer_store.py): at every commit each rank "
             "publishes its committed snapshot (host copies) over the "
             "rendezvous KV and mirrors peer (rank+1) % n's newest "
             "snapshot in host RAM, so a lost rank restores without the "
             "filesystem (disk stays the fallback tier).  Needs the "
             "elastic rendezvous env (HVDT_RENDEZVOUS_ADDR)."),
        Knob("HVDT_ELASTIC", False, _parse_bool,
             "Elastic (fault-tolerant) mode."),
        Knob("HVDT_CONTROL_PLANE_TIMEOUT_S", 300.0, float,
             "Eager control-plane gather/broadcast timeout — the failure-"
             "detection latency bound: a dead peer surfaces as this timeout "
             "firing, converted to HorovodInternalError.  Also the process "
             "group's collective timeout (init_process_group(timeout=))."),
        Knob("HVDT_DISABLE_PROFILER_RANGES", False, _parse_bool,
             "Disable the torch.profiler record_function ranges around "
             "eager ops."),
        Knob("HVDT_LOG_LEVEL", "warning", str,
             "trace|debug|info|warning|error|fatal"),
        Knob("HVDT_LOG_HIDE_TIME", False, _parse_bool,
             "Hide timestamps in log lines."),
        Knob("HVDT_RANK", -1, int, "Global process rank (set by launcher)."),
        Knob("HVDT_SIZE", -1, int, "Global process count (set by launcher)."),
        Knob("HVDT_LOCAL_RANK", -1, int,
             "Rank within the host (set by launcher)."),
        Knob("HVDT_LOCAL_SIZE", -1, int,
             "Processes on this host (set by launcher)."),
        Knob("HVDT_CROSS_RANK", -1, int, "Host index (set by launcher)."),
        Knob("HVDT_CROSS_SIZE", -1, int, "Number of hosts (set by launcher)."),
        Knob("HVDT_HOSTNAME", "", str, "Logical hostname assigned by launcher."),
        Knob("HVDT_COORDINATOR_ADDR", "", str,
             "host:port of the rendezvous (torch.distributed TCP store)."),
        Knob("HVDT_RENDEZVOUS_ADDR", "", str,
             "Rendezvous HTTP KV server address."),
        Knob("HVDT_RENDEZVOUS_PORT", 0, int,
             "Rendezvous HTTP KV server port."),
        Knob("HVDT_MESH_AXES", "", str,
             "Comma list of axis=size pairs for the default mesh init() "
             "builds, e.g. 'dp=4,tp=2'.  Empty = no mesh (the world is "
             "the data-parallel group)."),
    ]
}


def get(name: str) -> Any:
    return KNOBS[name].read()


def get_bool(name: str) -> bool:
    return bool(get(name))


def get_int(name: str) -> int:
    return int(get(name))


def get_float(name: str) -> float:
    return float(get(name))


def get_str(name: str) -> str:
    return str(get(name))
