"""CLI-flag / YAML-config / env translation for the launcher.

The port's copy of the JAX package's ``runner/config_parser.py``
(Horovod's runner/common/util/config_parser.py and runner/launch.py
:242-527): the same flags, YAML sections and precedence, so one command
line or config file drives either package's ``hvdtrun``.  A flag whose
knob the port registers (``common/config.py``) becomes the same
``HVDT_*`` env as in the reference; a flag whose knob the port lacks
is still parsed, and giving it (on the command line or in the file)
raises ``NotImplementedError`` naming its ROADMAP item.

Every runtime knob is settable from

  1. a CLI flag on ``hvdtrun``            (highest precedence)
  2. the caller's environment             (HVDT_*)
  3. a ``--config-file`` YAML             (sections below)
  4. the knob's built-in default          (common/config.py)

and the launcher forwards the result to every worker as ``HVDT_*`` env —
the same precedence order the reference implements by writing CLI/file
values into the env it hands to workers.

YAML shape (mirrors the reference's config sections)::

    params:
      fusion_threshold_mb: 32
      cycle_time_ms: 3.5
      cache_capacity: 2048
    autotune:
      enabled: true
      log_file: /tmp/autotune.csv
      warmup_samples: 3
      steps_per_sample: 10
      bayes_opt_max_samples: 20
      gaussian_process_noise: 0.8
    timeline:
      filename: /tmp/timeline.json
      mark_cycles: true
    stall_check:
      disabled: false
      warning_time_seconds: 60
      shutdown_time_seconds: 0
    resilience:
      async_ckpt: true
      peer_store: true
      ckpt_snapshot_budget_s: 1.0
    elastic:
      pod_size: 4
      pod_straggler_evict: 3
    controller:
      enabled: on
      cooldown_s: 60.0
      recovery_window: 3
      max_actions: 8
    fleet:
      enabled: on
      cooldown_s: 60.0
      enter_ratio: 1.2
      exit_ratio: 1.05
      backfill_ratio: 0.5
      recovery_window: 3
      max_moves: 0
      min_train_pods: 1
    telemetry:
      enabled: true
      metrics_port: 9090
      straggler_window: 64
      trace_dir: /tmp/hvdt-trace
      flight_recorder: true
    serve:
      replicas: 2
      max_replicas: 4
      autoscale: true
      slo_p99_ms: 250
      heartbeat_s: 2.0
    library_options:
      cpu_operations: tcp
      tcp_port_stride: 128
      compilation_cache_dir: /var/cache/hvdt-compile
    logging:
      level: info
      hide_timestamp: false
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Optional

__all__ = ["KNOB_FLAGS", "add_knob_arguments", "load_config_file",
           "apply_config_file", "env_from_args"]

# The flags whose knob the port does not register yet, by env name, with
# the ROADMAP Queue 1 item that ports it.
_CONTROL = "item 8: control, analysis and the edges"
UNPORTED_KNOBS: Dict[str, str] = {
    "HVDT_CONTROLLER": _CONTROL,
    "HVDT_CONTROLLER_COOLDOWN_S": _CONTROL,
    "HVDT_CONTROLLER_RECOVERY_WINDOW": _CONTROL,
    "HVDT_CONTROLLER_MAX_ACTIONS": _CONTROL,
    "HVDT_FLEET": _CONTROL,
    "HVDT_FLEET_COOLDOWN_S": _CONTROL,
    "HVDT_FLEET_ENTER_RATIO": _CONTROL,
    "HVDT_FLEET_EXIT_RATIO": _CONTROL,
    "HVDT_FLEET_BACKFILL_RATIO": _CONTROL,
    "HVDT_FLEET_RECOVERY_WINDOW": _CONTROL,
    "HVDT_FLEET_MIN_GAIN": _CONTROL,
    "HVDT_FLEET_MAX_MOVES": _CONTROL,
    "HVDT_FLEET_MIN_TRAIN_PODS": _CONTROL,
    "HVDT_CPU_OPERATIONS": _CONTROL,
    "HVDT_TCP_SET_PORT_STRIDE": _CONTROL,
    "HVDT_ALLREDUCE_DTYPE": _CONTROL,
}


@dataclasses.dataclass(frozen=True)
class _Flag:
    """One CLI flag ↔ one HVDT env var ↔ one YAML (section, key)."""
    flag: str                 # e.g. "--fusion-threshold-mb"
    dest: str                 # argparse dest
    env: str                  # HVDT_* var the value is forwarded as
    section: str              # YAML section
    key: str                  # YAML key within the section
    help: str
    type: Callable = str
    is_bool: bool = False     # store_true flag
    to_env: Callable[[Any], str] = staticmethod(lambda v: str(v))


def _mb_to_bytes(v) -> str:
    return str(int(float(v) * 1024 * 1024))


def _bool_env(v) -> str:
    return "1" if v else "0"


def _on_off_env(v) -> str:
    return "on" if v else "off"


KNOB_FLAGS: List[_Flag] = [
    # --- params (ref: config_parser.py set_args_from_config 'params') ---
    _Flag("--fusion-threshold-mb", "fusion_threshold_mb",
          "HVDT_FUSION_THRESHOLD", "params", "fusion_threshold_mb",
          "Tensor-fusion bucket size in MB.", type=float,
          to_env=_mb_to_bytes),
    _Flag("--cycle-time-ms", "cycle_time_ms", "HVDT_CYCLE_TIME",
          "params", "cycle_time_ms",
          "Eager background-cycle time in ms.", type=float),
    _Flag("--cache-capacity", "cache_capacity", "HVDT_CACHE_CAPACITY",
          "params", "cache_capacity",
          "Response-cache capacity.", type=int),
    _Flag("--overlap", "overlap", "HVDT_OVERLAP", "params", "overlap",
          "Overlapped gradient exchange on every worker (ops/overlap.py):"
          " reverse-topological bucket schedule with collectives issued "
          "as each segment's grads exist, pipelined int8 wire, fused-"
          "update latency hiding.", is_bool=True, to_env=_on_off_env),
    _Flag("--xla-latency-hiding", "xla_latency_hiding",
          "HVDT_XLA_LATENCY_HIDING", "params", "xla_latency_hiding",
          "The reference's XLA latency-hiding flags (auto|on|off; "
          "validated in hvd.init(), the port sets nothing: its overlap "
          "comes from --overlap)."),
    _Flag("--transport", "transport", "HVDT_TRANSPORT", "params",
          "transport",
          "Per-mesh-axis transport policy on every worker "
          "(horovod_tpu_torch/transport): axis:algorithm:wire[:threshold] "
          "entries, e.g. 'ici:ring:f32:64M,dcn:tree:int8:8M', or "
          "'auto' for the topology-derived default.  Multi-axis "
          "reduce groups then run the hierarchical allreduce "
          "(fast-axis reduce-scatter -> slow-axis shard exchange -> "
          "allgather); workers validate the grammar in hvd.init()."),
    _Flag("--zero", "zero", "HVDT_ZERO", "params", "zero",
          "ZeRO state-sharding stage on every worker (ops/zero.py): "
          "grads (reduce-scatter + allgather wire split), states "
          "(sharded optimizer moments, shard-local fused updates, "
          "parameter-delta allgather — optimizer HBM ~1/n), or params "
          "(parameters sharded between steps, gathered on demand).  "
          "Workers validate the stage in hvd.init()."),
    _Flag("--remat", "remat", "HVDT_REMAT", "params", "remat",
          "Activation rematerialization for the transformer block "
          "(none|full|dots): torch.utils.checkpoint per layer, 'dots' "
          "saving the matmul outputs — the memory-for-MFU trade next to "
          "--zero."),
    # --- autotune ---
    _Flag("--autotune", "autotune", "HVDT_AUTOTUNE", "autotune", "enabled",
          "Enable Bayesian autotuning of fusion knobs.", is_bool=True,
          to_env=_bool_env),
    _Flag("--autotune-log-file", "autotune_log_file", "HVDT_AUTOTUNE_LOG",
          "autotune", "log_file", "CSV log for autotune samples."),
    _Flag("--autotune-warmup-samples", "autotune_warmup_samples",
          "HVDT_AUTOTUNE_WARMUP_SAMPLES", "autotune", "warmup_samples",
          "Autotune warmup discard count.", type=int),
    _Flag("--autotune-steps-per-sample", "autotune_steps_per_sample",
          "HVDT_AUTOTUNE_STEPS_PER_SAMPLE", "autotune", "steps_per_sample",
          "Steps per autotune sample.", type=int),
    _Flag("--autotune-bayes-opt-max-samples", "autotune_bayes_opt_max_samples",
          "HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "autotune",
          "bayes_opt_max_samples", "Max Bayesian-optimizer samples.",
          type=int),
    _Flag("--autotune-gaussian-process-noise", "autotune_gp_noise",
          "HVDT_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", "autotune",
          "gaussian_process_noise", "GP noise alpha.", type=float),
    # --- timeline ---
    _Flag("--timeline-filename", "timeline_filename", "HVDT_TIMELINE",
          "timeline", "filename",
          "Write Chrome-tracing timeline JSON to this path."),
    _Flag("--timeline-mark-cycles", "timeline_mark_cycles",
          "HVDT_TIMELINE_MARK_CYCLES", "timeline", "mark_cycles",
          "Mark background cycles in the timeline.", is_bool=True,
          to_env=_bool_env),
    # --- stall check ---
    _Flag("--no-stall-check", "no_stall_check", "HVDT_STALL_CHECK_DISABLE",
          "stall_check", "disabled", "Disable the stall inspector.",
          is_bool=True, to_env=_bool_env),
    _Flag("--stall-check-warning-time-seconds", "stall_warning_time",
          "HVDT_STALL_CHECK_TIME_SECONDS", "stall_check",
          "warning_time_seconds", "Stall warning threshold.", type=int),
    _Flag("--stall-check-shutdown-time-seconds", "stall_shutdown_time",
          "HVDT_STALL_SHUTDOWN_TIME_SECONDS", "stall_check",
          "shutdown_time_seconds", "Stall abort threshold (0 = never).",
          type=int),
    _Flag("--stall-abort-time-seconds", "stall_abort_time",
          "HVDT_STALL_ABORT_TIME_SECONDS", "stall_check",
          "abort_time_seconds",
          "Escalation rung: abort a stalled negotiation past this age "
          "(waiters raise, elastic retry recovers; 0 = off).", type=int),
    _Flag("--stall-reset-time-seconds", "stall_reset_time",
          "HVDT_STALL_RESET_TIME_SECONDS", "stall_check",
          "reset_time_seconds",
          "Escalation rung: request an elastic re-rendezvous past this "
          "age (0 = off).", type=int),
    # --- resilience / chaos ---
    _Flag("--fault-plan", "fault_plan", "HVDT_FAULT_PLAN",
          "resilience", "fault_plan",
          "Deterministic fault-injection plan for chaos runs, e.g. "
          "'crash@step=12:rank=1,3' (rank sets/ranges), "
          "'pod_crash@step=10:pod=podB,kv_drop@p=0.1' "
          "(resilience/faults.py grammar)."),
    _Flag("--async-ckpt", "async_ckpt", "HVDT_ASYNC_CKPT",
          "resilience", "async_ckpt",
          "Asynchronous non-blocking checkpointing on every worker: "
          "commit-point device->host snapshot + background writer; "
          "LAST_GOOD advances only after manifest fsync "
          "(checkpoint.py save_async).", is_bool=True, to_env=_bool_env),
    _Flag("--peer-store", "peer_store", "HVDT_PEER_STORE",
          "resilience", "peer_store",
          "Peer-replicated in-memory snapshot tier: commit snapshots "
          "ride the rendezvous KV and mirror in peer RAM, so a lost "
          "rank/pod restores without touching the filesystem "
          "(resilience/peer_store.py).", is_bool=True, to_env=_bool_env),
    _Flag("--ckpt-snapshot-budget-s", "ckpt_snapshot_budget_s",
          "HVDT_CKPT_SNAPSHOT_BUDGET_S", "resilience",
          "ckpt_snapshot_budget_s",
          "Stall budget (seconds) for the commit-point checkpoint "
          "snapshot under --async-ckpt; overruns are warned and "
          "counted.", type=float),
    # --- elastic / pods ---
    _Flag("--pod-size", "pod_size", "HVDT_POD_SIZE",
          "elastic", "pod_size",
          "Slots per pod for the pod-granular elastic control plane: "
          "groups discovery hosts without an @pod column into pods of "
          "this many slots; resize/blacklist/recovery then happen at "
          "pod granularity and workers get the two-level (dcn, ici) "
          "mesh contract (HVDT_NUM_PODS/HVDT_POD_SIZE).", type=int),
    _Flag("--pod-straggler-evict", "pod_straggler_evict",
          "HVDT_POD_STRAGGLER_EVICT", "elastic", "pod_straggler_evict",
          "Evict a pod whose median step time exceeds the straggler "
          "threshold for this many consecutive telemetry windows "
          "(0 = off; needs --telemetry so workers publish snapshots).",
          type=int),
    _Flag("--blacklist-cooldown", "blacklist_cooldown",
          "HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "resilience",
          "blacklist_cooldown_s",
          "Seconds a failed host sits out of elastic discovery before "
          "becoming eligible again (0 = permanent blacklist).",
          type=float),
    # --- closed-loop policy controller (control/controller.py; runs in
    #     the elastic driver's discovery loop and prices sensor-plane
    #     events with the cost model before acting) ---
    _Flag("--controller", "controller", "HVDT_CONTROLLER",
          "controller", "enabled",
          "Enable the driver-side policy controller (on | observe | "
          "off): subscribes to the cluster anomaly event stream, prices "
          "candidate actions (transport flip, bucket retune, "
          "overlap/ZeRO toggle, pod evict, resize, replica scale) with "
          "the cost model offline, and applies the winner at a step "
          "boundary through the no-recompile autotune legs; 'observe' "
          "logs priced decisions without acting (needs --telemetry)."),
    _Flag("--controller-cooldown-s", "controller_cooldown_s",
          "HVDT_CONTROLLER_COOLDOWN_S", "controller", "cooldown_s",
          "Per-action-kind cooldown (seconds) between controller "
          "actions of the same kind; doubled after a rollback.",
          type=float),
    _Flag("--controller-recovery-window", "controller_recovery_window",
          "HVDT_CONTROLLER_RECOVERY_WINDOW", "controller",
          "recovery_window",
          "Telemetry ticks the controller waits for "
          "hvdt_perf_deviation_ratio to recover below the exit band "
          "before rolling a reversible action back.", type=int),
    _Flag("--controller-max-actions", "controller_max_actions",
          "HVDT_CONTROLLER_MAX_ACTIONS", "controller", "max_actions",
          "Lifetime cap on applied controller actions per run "
          "(0 = unlimited).", type=int),
    # --- fleet scheduler (fleet/scheduler.py; bin-packs one pod fleet
    #     between elastic training and SLO serving, pricing every
    #     reclaim/backfill with the cost model before committing) ---
    _Flag("--fleet", "fleet", "HVDT_FLEET", "fleet", "enabled",
          "Enable the fleet scheduler (on | observe | off): one "
          "bin-packing reconciler over the shared pod inventory that "
          "reclaims training pods for serving when SLO pressure "
          "crosses the enter band and backfills training from "
          "serving's trough, pricing each move with the cost model "
          "(training throughput at the candidate world size vs "
          "serving headroom); 'observe' logs priced decisions without "
          "moving a pod."),
    _Flag("--fleet-cooldown-s", "fleet_cooldown_s",
          "HVDT_FLEET_COOLDOWN_S", "fleet", "cooldown_s",
          "Seconds between fleet moves of the same kind; doubled "
          "after a rollback.", type=float),
    _Flag("--fleet-enter-ratio", "fleet_enter_ratio",
          "HVDT_FLEET_ENTER_RATIO", "fleet", "enter_ratio",
          "Serving-pressure ratio at which the scheduler starts "
          "reclaiming training pods for serving.", type=float),
    _Flag("--fleet-exit-ratio", "fleet_exit_ratio",
          "HVDT_FLEET_EXIT_RATIO", "fleet", "exit_ratio",
          "Serving-pressure ratio below which a pending reclaim "
          "counts as recovered (hysteresis exit band).", type=float),
    _Flag("--fleet-backfill-ratio", "fleet_backfill_ratio",
          "HVDT_FLEET_BACKFILL_RATIO", "fleet", "backfill_ratio",
          "Serving-pressure ratio below which serving's trough is "
          "backfilled into training.", type=float),
    _Flag("--fleet-recovery-window", "fleet_recovery_window",
          "HVDT_FLEET_RECOVERY_WINDOW", "fleet", "recovery_window",
          "Scheduler ticks a move has to prove itself before the "
          "never-worse check considers rolling it back.", type=int),
    _Flag("--fleet-min-gain", "fleet_min_gain",
          "HVDT_FLEET_MIN_GAIN", "fleet", "min_gain",
          "Minimum predicted gain for a fleet move to apply.",
          type=float),
    _Flag("--fleet-max-moves", "fleet_max_moves",
          "HVDT_FLEET_MAX_MOVES", "fleet", "max_moves",
          "Lifetime cap on applied fleet moves per run "
          "(0 = unlimited).", type=int),
    _Flag("--fleet-min-train-pods", "fleet_min_train_pods",
          "HVDT_FLEET_MIN_TRAIN_PODS", "fleet", "min_train_pods",
          "Floor on training pods the scheduler will never reclaim "
          "below.", type=int),
    # --- telemetry / observability ---
    _Flag("--telemetry", "telemetry", "HVDT_TELEMETRY",
          "telemetry", "enabled",
          "Enable the unified telemetry subsystem on every worker: "
          "per-collective metrics, step stats (MFU/goodput), straggler "
          "detection, and the /metrics HTTP exporter.", is_bool=True,
          to_env=_bool_env),
    _Flag("--metrics-port", "metrics_port", "HVDT_METRICS_PORT",
          "telemetry", "metrics_port",
          "Base port for each worker's /metrics + /healthz exporter "
          "(worker binds base + local_rank; 0 = ephemeral).", type=int),
    _Flag("--straggler-window", "straggler_window",
          "HVDT_STRAGGLER_WINDOW", "telemetry", "straggler_window",
          "Steps between cross-rank straggler checks (0 = off).",
          type=int),
    _Flag("--trace-dir", "trace_dir", "HVDT_TRACE_DIR",
          "telemetry", "trace_dir",
          "Enable distributed span tracing on every worker and collect "
          "per-rank Chrome-trace dumps (plus desync reports) in this "
          "directory; the elastic driver additionally merges per-rank "
          "dumps into trace_merged.json with rank as pid."),
    _Flag("--flight-recorder", "flight_recorder", "HVDT_FLIGHT_RECORDER",
          "telemetry", "flight_recorder",
          "Enable the per-rank collective flight recorder (ring buffer "
          "of recent collective events; dumped on stall-abort with a "
          "cross-rank desync report, on preemption, and via the "
          "exporter's /flightrecorder endpoint).", is_bool=True,
          to_env=_bool_env),
    # --- serving control plane (serve/autoscale.py + serve/router.py;
    #     `hvdtrun serve` reads the same HVDT_SERVE_* envs, so a YAML
    #     serve: section configures a fleet launch end to end) ---
    _Flag("--serve-replicas", "serve_replicas", "HVDT_SERVE_REPLICAS",
          "serve", "replicas",
          "Initial replica count for the elastic serving control plane "
          "(`hvdtrun serve --replicas` reads this default).", type=int),
    _Flag("--serve-max-replicas", "serve_max_replicas",
          "HVDT_SERVE_MAX_REPLICAS", "serve", "max_replicas",
          "Autoscaler replica ceiling / localhost slot count.",
          type=int),
    _Flag("--serve-autoscale", "serve_autoscale", "HVDT_SERVE_AUTOSCALE",
          "serve", "autoscale",
          "Enable the serving replica autoscaler (queue depth + "
          "p99-vs-SLO from the KV heartbeats).", is_bool=True,
          to_env=_bool_env),
    _Flag("--serve-slo-p99-ms", "serve_slo_p99_ms",
          "HVDT_SERVE_SLO_P99_MS", "serve", "slo_p99_ms",
          "Serving p99 SLO (ms): router ejection + autoscale-up "
          "threshold (0 = off).", type=float),
    _Flag("--serve-heartbeat-s", "serve_heartbeat_s",
          "HVDT_SERVE_HEARTBEAT_S", "serve", "heartbeat_s",
          "Replica heartbeat period (s); 2x this is the router's "
          "dead-replica bound.", type=float),
    # --- library options ---
    _Flag("--cpu-operations", "cpu_operations", "HVDT_CPU_OPERATIONS",
          "library_options", "cpu_operations",
          "Host-collective data plane: xla | tcp."),
    _Flag("--compilation-cache-dir", "compilation_cache_dir",
          "HVDT_COMPILATION_CACHE", "library_options",
          "compilation_cache_dir",
          "Directory for what every worker compiles at run time (the "
          "torch inductor and Triton caches; step_pipeline."
          "enable_compilation_cache)."),
    _Flag("--tcp-port-stride", "tcp_port_stride",
          "HVDT_TCP_SET_PORT_STRIDE", "library_options", "tcp_port_stride",
          "Port stride between process sets' TCP meshes.", type=int),
    # --- logging ---
    _Flag("--log-level", "log_level", "HVDT_LOG_LEVEL", "logging", "level",
          "trace|debug|info|warning|error|fatal."),
    _Flag("--log-hide-timestamp", "log_hide_timestamp",
          "HVDT_LOG_HIDE_TIME", "logging", "hide_timestamp",
          "Hide timestamps in worker log lines.", is_bool=True,
          to_env=_bool_env),
    # --- numerics ---
    _Flag("--allreduce-dtype", "allreduce_dtype", "HVDT_ALLREDUCE_DTYPE",
          "params", "allreduce_dtype",
          "Wire dtype for allreduce (e.g. bfloat16 for on-the-wire "
          "compression)."),
    _Flag("--compression", "compression", "HVDT_COMPRESSION",
          "params", "compression",
          "Gradient wire compressor by name: none|bf16|fp16|int8|int4 "
          "(int8/int4 = block-scaled quantized collectives, int4 packed "
          "two lanes per byte, horovod_tpu_torch/"
          "quant).  Workers resolve it in hvd.init()/"
          "DistributedOptimizer; unknown names fail init with the "
          "valid list."),
    # --- mesh ---
    _Flag("--mesh-axes", "mesh_axes", "HVDT_MESH_AXES", "params",
          "mesh_axes", "Default mesh axes, e.g. 'dp=4,tp=2'."),
]


def add_knob_arguments(parser: argparse.ArgumentParser) -> None:
    """Add every knob flag (default=None so 'explicitly set on the CLI'
    is detectable — the precedence rules depend on it)."""
    g = parser.add_argument_group(
        "runtime knobs",
        "Forwarded to workers as HVDT_* env. Precedence: CLI > caller env "
        "> --config-file > default.")
    for f in KNOB_FLAGS:
        if f.is_bool:
            g.add_argument(f.flag, dest=f.dest, action="store_const",
                           const=True, default=None, help=f.help)
        else:
            g.add_argument(f.flag, dest=f.dest, type=f.type, default=None,
                           help=f.help)


def load_config_file(path: str) -> Dict[str, Dict[str, Any]]:
    """Parse the YAML config file into {section: {key: value}}."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must be a YAML mapping")
    return data


def apply_config_file(args: argparse.Namespace, path: Optional[str]
                      ) -> Dict[str, Any]:
    """Returns {dest: value} of file-provided knobs (file values NEVER
    overwrite args — CLI wins; env-vs-file precedence is resolved in
    :func:`env_from_args`)."""
    if not path:
        return {}
    data = load_config_file(path)
    out: Dict[str, Any] = {}
    known = {(f.section, f.key): f for f in KNOB_FLAGS}
    for section, body in data.items():
        if not isinstance(body, dict):
            raise ValueError(f"config section {section!r} must be a mapping")
        for key, value in body.items():
            f = known.get((section, key))
            if f is None:
                raise ValueError(
                    f"unknown config entry {section}.{key} "
                    f"(known: {sorted(k for k in known)})")
            out[f.dest] = value
    return out


def env_from_args(args: argparse.Namespace,
                  file_values: Dict[str, Any],
                  base_env: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    """HVDT_* env to forward to workers, honoring
    CLI > caller env > config file > default.

    ``base_env`` defaults to ``os.environ``; a file value only applies
    when the var is absent there, while a CLI value always wins.  A flag
    of :data:`UNPORTED_KNOBS` given on the CLI or in the file raises.
    """
    import os

    env = dict(os.environ) if base_env is None else dict(base_env)
    out: Dict[str, str] = {}
    for f in KNOB_FLAGS:
        cli_val = getattr(args, f.dest, None)
        item = UNPORTED_KNOBS.get(f.env)
        if item is not None:
            if cli_val is not None or f.dest in file_values:
                raise NotImplementedError(
                    f"{f.flag} ({f.env}) is not ported yet (ROADMAP "
                    f"Queue 1, {item})")
            continue
        if cli_val is not None:
            out[f.env] = f.to_env(cli_val)
        elif f.env in env:
            out[f.env] = env[f.env]
        elif f.dest in file_values:
            out[f.env] = f.to_env(file_values[f.dest])
    return out
