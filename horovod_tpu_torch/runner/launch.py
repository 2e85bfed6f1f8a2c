"""``hvdtrun`` — the port's horovodrun-equivalent CLI.

The counterpart of the JAX package's ``runner/launch.py`` (Horovod's
runner/launch.py: parse_args :242-527, _run_static :528, _run_elastic
:621, and runner/gloo_run.py:240 launch_gloo)::

    python -m horovod_tpu_torch.runner.launch -np 4 -- python train.py
    python -m horovod_tpu_torch.runner.launch --host-discovery-script \
        ./discover.sh --min-np 2 --max-np 4 -- python train.py

One worker process a slot, with the ``HVDT_*`` env contract
``horovod_tpu_torch.init()`` reads: a slot's ``HVDT_LOCAL_RANK`` picks
its card, and rank 0's ``HVDT_COORDINATOR_ADDR`` hosts the
``torch.distributed`` TCP store.  The launcher checks that a host's
local slots do not outnumber its cards (``torch.cuda.device_count()``)
unless the worker command asks for the CPU (``--device cpu``); it never
falls back to the CPU by itself.

Flow (static):
  parse hosts → SlotInfo assignments (hosts.py) → start RendezvousServer →
  publish cluster spec → spawn one shell per slot (local exec or ssh) with
  the HVDT_* env contract → stream rank-prefixed output → first non-zero
  exit terminates the job (ref: gloo_run.py:134-197 terminate_all).
"""

from __future__ import annotations

import argparse
import os
import shlex
import socket
import sys
import threading
from typing import Dict, List, Optional

from . import hosts as hosts_mod
from .config_parser import add_knob_arguments, apply_config_file, env_from_args
from .http_kv import RendezvousServer, new_secret
from .safe_shell_exec import safe_execute

__all__ = ["main", "parse_args", "run_static"]

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}

# The reference's subcommands the port lacks, by the ROADMAP Queue 1 item
# that ports them: the fleet simulator and the static-analysis gate.
_UNPORTED_SUBCOMMANDS = {
    "fleet": "item 8: control, analysis and the edges",
    "lint": "item 8: control, analysis and the edges",
}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="hvdtrun",
        description="Launch distributed training on CUDA hosts "
                    "(horovodrun-equivalent).")
    p.add_argument("-V", "--version", action="store_true", dest="version",
                   help="Print the horovod_tpu_torch version and exit.")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="Print build capabilities (NCCL, gloo, CUDA cards) "
                        "and exit (ref: horovodrun --check-build).")
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="Total number of worker processes.")
    p.add_argument("--network-interface", "--nics", dest="nics",
                   default=None,
                   help="Comma-separated NIC allowlist: the launcher "
                        "advertises its rendezvous/KV address from the "
                        "first matching interface (static and elastic), "
                        "and exports HVDT_NICS to workers.")
    p.add_argument("--disable-cache", action="store_true",
                   help="Disable the controller response cache "
                        "(HVDT_CACHE_CAPACITY=0; every collective "
                        "renegotiates, ref: --disable-cache).")
    p.add_argument("-H", "--hosts", default=None,
                   help='Comma-separated "host:slots" list.')
    p.add_argument("--hostfile", default=None,
                   help='Hostfile with "host slots=N" lines.')
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("--ssh-identity-file", default=None)
    p.add_argument("--coordinator-port", type=int, default=29500,
                   help="Port of the torch.distributed TCP store on rank "
                        "0's host.")
    p.add_argument("--start-timeout", type=float, default=600.0)
    p.add_argument("--output-filename", default=None,
                   help="Mux per-rank output into <dir>/rank.<N> files.")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--config-file", default=None,
                   help="YAML file with runtime-knob sections (see "
                        "runner/config_parser.py). Precedence: CLI > "
                        "caller env > config file > default.")
    p.add_argument("--no-preflight", action="store_true",
                   help="Skip the host-reachability preflight probe.")
    add_knob_arguments(p)
    # Elastic flags (ref: launch.py elastic group)
    p.add_argument("--host-discovery-script", default=None,
                   help="Executable printing current 'host:slots' lines; "
                        "enables elastic mode.")
    p.add_argument("--min-np", type=int, default=None)
    p.add_argument("--max-np", type=int, default=None)
    p.add_argument("--slots-per-host", type=int, default=1)
    p.add_argument("--reset-limit", type=int, default=None,
                   help="Max worker resets before aborting the elastic job.")
    p.add_argument("--elastic-timeout", type=float, default=600.0,
                   help="Seconds to wait for min-np slots at each elastic "
                        "rendezvous (ref: --elastic-timeout).")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Training command, e.g. python train.py")
    args = p.parse_args(argv)
    if args.version or args.check_build:
        return args
    if not args.command:
        p.error("no training command given")
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    return args


def _print_check_build() -> None:
    """--check-build / --version output (ref: horovodrun --check-build
    prints the framework/controller/transport capability table)."""
    import horovod_tpu_torch as hvd

    print(f"horovod_tpu_torch v{hvd.__version__}")
    rows = [
        ("NCCL", hvd.nccl_built()),
        ("gloo", hvd.gloo_built()),
        ("CUDA build", hvd.cuda_built()),
    ]
    print("\nAvailable capabilities:")
    for name, ok in rows:
        print(f"    [{'X' if ok else ' '}] {name}")
    print(f"\nCUDA cards visible: {_card_count()}")


def _card_count() -> int:
    import torch

    return torch.cuda.device_count()


def asks_for_cpu(command: List[str]) -> bool:
    """Whether the worker command asks for the CPU (``--device cpu`` or
    ``--device=cpu``, the flag the port's entry points take)."""
    return any(a == "--device=cpu" or (a == "--device" and nxt == "cpu")
               for a, nxt in zip(command, list(command[1:]) + [""]))


def check_local_cards(slots: List[hosts_mod.SlotInfo],
                      command: List[str]) -> None:
    """Refuse more local slots than this host has CUDA cards: each slot
    drives the card of its local rank.  A worker command that asks for
    the CPU is not checked.  Raises ``RuntimeError``; never falls back to
    the CPU."""
    if asks_for_cpu(command):
        return
    local = sum(1 for s in slots if _is_local(s.hostname))
    if not local:
        return
    cards = _card_count()
    if local > cards:
        raise RuntimeError(
            f"hvdtrun: {local} local slot(s) but {cards} CUDA card(s) "
            "visible; each slot drives one card.  Lower -np, or pass "
            "--device cpu to a worker that runs on the CPU.")


def _is_local(hostname: str) -> bool:
    return (hostname in _LOCAL_NAMES
            or hostname == socket.gethostname()
            or hostname == socket.getfqdn())


def _ssh_prefix(args, hostname: str) -> str:
    opts = "-o StrictHostKeyChecking=no -o BatchMode=yes"
    if args.ssh_port:
        opts += f" -p {args.ssh_port}"
    if args.ssh_identity_file:
        opts += f" -i {shlex.quote(args.ssh_identity_file)}"
    return f"ssh {opts} {shlex.quote(hostname)}"


def _build_command(args, slot: hosts_mod.SlotInfo, base_env: Dict[str, str],
                   command: List[str]) -> (str, Dict[str, str]):
    env = dict(os.environ)
    env.update(base_env)
    env.update(slot.to_env())
    cmd = " ".join(shlex.quote(c) for c in command)
    if _is_local(slot.hostname):
        return cmd, env
    # Remote: forward the contract env explicitly through ssh.
    exports = " ".join(
        f"{k}={shlex.quote(v)}" for k, v in {**base_env,
                                             **slot.to_env()}.items())
    return (f"{_ssh_prefix(args, slot.hostname)} "
            f"{shlex.quote(f'cd {os.getcwd()} && env {exports} {cmd}')}",
            dict(os.environ))


def knob_env_for(args) -> Dict[str, str]:
    """Resolve the runtime-knob env contract for workers (CLI > caller
    env > --config-file > default; ref: config_parser.py precedence)."""
    file_values = apply_config_file(args, getattr(args, "config_file", None))
    env = env_from_args(args, file_values)
    if getattr(args, "disable_cache", False):
        env["HVDT_CACHE_CAPACITY"] = "0"
    if getattr(args, "nics", None):
        env["HVDT_NICS"] = args.nics
    return env


def _nic_addr(nics: List[str]) -> Optional[str]:
    """IPv4 address of the first present interface in ``nics`` (the
    --network-interface allowlist; ref: driver_service NIC selection).
    Linux SIOCGIFADDR — returns None when none match."""
    import fcntl
    import struct

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for nic in nics:
            try:
                packed = fcntl.ioctl(
                    s.fileno(), 0x8915,  # SIOCGIFADDR
                    struct.pack("256s", nic.strip()[:15].encode()))
                return socket.inet_ntoa(packed[20:24])
            except OSError:
                continue
    finally:
        s.close()
    return None


def preflight_reachability(args, slots: List[hosts_mod.SlotInfo],
                           addr: str, port: int) -> None:
    """Probe that every worker host can reach the launcher's rendezvous
    server before any rank is spawned — the analog of the reference's
    driver/NIC discovery (ref: runner/driver/driver_service.py:162-260,
    which probes mutually-routable interfaces).  The failure mode worth
    catching is "this host can't reach the coordinator address at all" — fail fast, naming the host,
    instead of an opaque rendezvous timeout minutes later.
    """
    import subprocess

    probe_py = (f"import socket;"
                f"socket.create_connection(('{addr}',{port}),timeout=10);"
                f"print('ok')")
    seen = set()
    for slot in slots:
        host = slot.hostname
        if host in seen:
            continue
        seen.add(host)
        if _is_local(host):
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=10).close()
            except OSError as e:
                raise RuntimeError(
                    f"preflight: host {host!r} (local) cannot reach the "
                    f"rendezvous server at 127.0.0.1:{port} — {e!r}. "
                    f"Pass --no-preflight to skip.") from e
            continue
        cmd = (f"{_ssh_prefix(args, host)} "
               f"{shlex.quote(f'python3 -c {shlex.quote(probe_py)}')}")
        try:
            res = subprocess.run(cmd, shell=True, capture_output=True,
                                 text=True, timeout=30)
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"preflight: host {host!r} did not answer the "
                f"reachability probe to {addr}:{port} within 30s")
        if res.returncode != 0 or "ok" not in res.stdout:
            raise RuntimeError(
                f"preflight: host {host!r} cannot reach the rendezvous "
                f"server at {addr}:{port} — "
                f"{(res.stderr or res.stdout).strip()[-300:]!r}. "
                f"Check that the launcher's address is routable from the "
                f"worker (wrong NIC?) or pass --no-preflight to skip.")


def run_static(args) -> int:
    """Static launch (ref: launch.py:528 _run_static + gloo_run.py:240)."""
    if args.hostfile:
        host_list = hosts_mod.parse_host_files(args.hostfile)
    elif args.hosts:
        host_list = hosts_mod.parse_hosts(args.hosts)
    else:
        host_list = [hosts_mod.HostInfo("localhost",
                                        args.num_proc or 1)]
    np_ = args.num_proc or sum(h.slots for h in host_list)
    slots = hosts_mod.get_host_assignments(host_list, np_)
    check_local_cards(slots, args.command)

    server = RendezvousServer(secret=new_secret())
    port = server.start()
    my_addr = socket.gethostbyname(socket.gethostname()) \
        if any(not _is_local(s.hostname) for s in slots) else "127.0.0.1"
    if getattr(args, "nics", None):
        # --network-interface: advertise the rendezvous on the allowed
        # NIC's address (workers then reach the coordinator over it).
        nic_addr = _nic_addr(args.nics.split(","))
        if nic_addr:
            my_addr = nic_addr
        else:
            print(f"hvdtrun: none of --network-interface {args.nics} "
                  "present on this host; using default address",
                  file=sys.stderr)
    coord_host = slots[0].hostname
    if _is_local(coord_host):
        coord_host = "127.0.0.1"
    base_env = {
        "HVDT_RENDEZVOUS_ADDR": my_addr,
        "HVDT_RENDEZVOUS_PORT": str(port),
        "HVDT_SECRET": server.secret.hex(),
        "HVDT_COORDINATOR_ADDR": f"{coord_host}:{args.coordinator_port}",
    }
    base_env.update(knob_env_for(args))
    server.put_local("/cluster/size", str(np_).encode())
    if not getattr(args, "no_preflight", False):
        try:
            preflight_reachability(args, slots, my_addr, port)
        except RuntimeError:
            server.stop()
            raise

    terminate = threading.Event()
    exit_codes: Dict[int, int] = {}
    lock = threading.Lock()

    def _run_slot(slot: hosts_mod.SlotInfo):
        cmd, env = _build_command(args, slot, base_env, args.command)
        out = err = None
        if args.output_filename:
            os.makedirs(args.output_filename, exist_ok=True)
            out = open(os.path.join(args.output_filename,
                                    f"rank.{slot.rank}"), "w")
            err = out
        prefix = f"[{slot.rank}]<stdout>:" if args.verbose else ""
        code = safe_execute(cmd, env=env, stdout=out, stderr=err,
                            prefix=prefix, terminate_event=terminate)
        with lock:
            exit_codes[slot.rank] = code
        if code != 0:
            terminate.set()
        if out is not None:
            out.close()

    threads = [threading.Thread(target=_run_slot, args=(s,), daemon=True)
               for s in slots]
    for t in threads:
        t.start()
    try:
        for t in threads:
            t.join()
    except KeyboardInterrupt:
        terminate.set()
        for t in threads:
            t.join(timeout=10)
        return 130
    finally:
        server.stop()
    failed = {r: c for r, c in exit_codes.items() if c != 0}
    if failed:
        rank, code = sorted(failed.items())[0]
        print(f"hvdtrun: rank {rank} exited with code {code}",
              file=sys.stderr)
        return code
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv and argv[0] in _UNPORTED_SUBCOMMANDS:
        raise NotImplementedError(
            f"hvdtrun {argv[0]} is not ported yet (ROADMAP Queue 1, "
            f"{_UNPORTED_SUBCOMMANDS[argv[0]]})")
    if argv and argv[0] == "serve":
        # `hvdtrun serve ...` — the serving plane.  Bare: one replica,
        # direct HTTP.  With --replicas/--autoscale: the elastic serving
        # control plane (serve/autoscale.py) — rendezvous KV + replica
        # fleet + SLO router.  Flags after `serve` are the serve CLI's
        # (horovod_tpu_torch/serve/__main__.py).
        from ..serve import main as serve_main

        return serve_main(argv[1:])
    if argv and argv[0] == "top":
        # `hvdtrun top ...` — live terminal view over worker /timeseries
        # endpoints (telemetry/top.py).  Flags after `top` are the top
        # CLI's (--endpoints/--interval/--once/--event-log).
        from ..telemetry.top import main as top_main

        return top_main(argv[1:])
    args = parse_args(argv)
    if args.version or args.check_build:
        _print_check_build()
        return 0
    if args.host_discovery_script:
        from .elastic.driver import run_elastic

        return run_elastic(args)
    return run_static(args)


if __name__ == "__main__":
    sys.exit(main())
