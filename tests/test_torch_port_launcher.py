"""PyTorch port: end to end through the port's own launcher
(``python -m horovod_tpu_torch.runner.launch``) with gloo CPU workers.

The worker script is written by the test into ``tmp_path``: a linear
model trained by the port's ``DistributedOptimizer`` under
``hvd.elastic.run`` with an ``interop.torch_elastic.TorchState`` that
persists its commits (every 5 batches), logging "rank size batch
lr_milli ts_ms" lines (the reference's log contract,
tests/test_elastic_integration.py).  Three launcher runs, started
together (each on its own coordinator port) so their start-ups overlap:

* static ``-np 2``: both ranks' all-reduce outputs, exit 0;
* ``--elastic`` with a discovery script going from ``localhost:2`` to
  ``localhost:1`` mid-run: the reference's shrink contract (both sizes
  seen, the 1-world resumes from a commit past batch 1, only rank 0 in
  it, the LR rescaled 2x → 1x, the target batch reached, bounded
  recovery);
* ``--elastic`` with ``crash@step=7:rank=1`` and a 1 s blacklist
  cooldown: the driver ends the generation, respawns both slots, rank 1
  resumes from the batch-5 commit, and the final parameters equal an
  uninterrupted run's (the same arithmetic simulated in this process)
  exactly.
"""

import importlib.util
import os
import socket
import stat
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_LR_MILLI = 100
TOTAL = {"shrink": 40, "crash": 15}

WORKER = textwrap.dedent('''
    """Worker for the port's launcher tests (CPU, gloo)."""
    import os
    import sys
    import time

    import torch

    BASE_LR = 0.1


    def batch_of(batch, rank):
        g = torch.Generator().manual_seed(1000 * batch + rank)
        return torch.randn(4, 3, generator=g)


    def make_model():
        torch.manual_seed(0)
        return torch.nn.Linear(3, 2)


    def loss_of(model, x):
        return (model(x) - 1.0).square().mean()


    def simulate(world, total):
        """The uninterrupted run's arithmetic in one process: the ranks'
        gradients summed, then divided by the world size."""
        model = make_model()
        opt = torch.optim.SGD(model.parameters(), lr=BASE_LR * world)
        for batch in range(1, total + 1):
            grads = []
            for rank in range(world):
                model.zero_grad()
                loss_of(model, batch_of(batch, rank)).backward()
                grads.append([p.grad.clone() for p in model.parameters()])
            for i, p in enumerate(model.parameters()):
                acc = grads[0][i].clone()
                for g in grads[1:]:
                    acc += g[i]
                p.grad = acc / world
            opt.step()
        return [p.detach() for p in model.parameters()]


    def main():
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.interop.torch_elastic import TorchState
        from horovod_tpu_torch.resilience import faults

        hvd.init(device="cpu")
        if sys.argv[1] == "static":
            out = hvd.allreduce(torch.full((2,), hvd.rank() + 1.0),
                                op=hvd.Sum)
            print(f"rank {hvd.rank()} of {hvd.size()}: {out.tolist()}")
            hvd.shutdown()
            return 0
        log = os.environ["TEST_LOG"]
        total = int(os.environ["TEST_BATCHES"])
        pause = float(os.environ["TEST_SLEEP"])
        model = make_model()
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=BASE_LR))
        state = TorchState(model, opt, batch=0, path=os.environ["TEST_STATE"])

        @hvd.elastic.run
        def train(state):
            lr = BASE_LR * hvd.size()
            for group in opt.param_groups:
                group["lr"] = lr
            inj = faults.get_injector()
            while state.batch < total:
                if inj is not None:
                    inj.fire("step", step=state.batch + 1)
                opt.zero_grad()
                loss_of(model, batch_of(state.batch + 1, hvd.rank())).backward()
                opt.step()
                state.batch += 1
                with open(log, "a") as f:
                    f.write(f"{hvd.rank()} {hvd.size()} {state.batch} "
                            f"{int(lr * 1000)} {int(time.time() * 1000)}\\n")
                if state.batch % 5 == 0:
                    state.commit()
                time.sleep(pause)

        train(state)
        if hvd.rank() == 0:
            torch.save([p.detach() for p in model.parameters()],
                       os.environ["TEST_STATE"] + ".final")
        hvd.shutdown()
        return 0


    if __name__ == "__main__":
        sys.exit(main())
''')


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _discovery(path, control, before, after):
    path.write_text(f"#!/bin/sh\nif [ -f {control} ]; then echo {after}; "
                    f"else echo {before}; fi\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _rows(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [tuple(map(int, ln.split())) for ln in f if ln.strip()]


class _Run:
    def __init__(self, tmp, name, launcher_args, worker_args, env=None):
        self.dir = tmp / name
        self.dir.mkdir()
        self.log = str(self.dir / "progress.log")
        self.state = str(self.dir / "state.pt")
        e = dict(os.environ)
        e.update({"PYTHONPATH": REPO + os.pathsep + e.get("PYTHONPATH", ""),
                  "TEST_LOG": self.log, "TEST_STATE": self.state,
                  "TEST_BATCHES": str(TOTAL.get(name, 1)),
                  "TEST_SLEEP": "0.1", **(env or {})})
        for k in ("HVDT_FAULT_PLAN", "HVDT_RANK", "HVDT_SIZE",
                  "HVDT_COORDINATOR_ADDR", "HVDT_ELASTIC"):
            if k not in (env or {}):
                e.pop(k, None)
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "--coordinator-port", str(_free_port()), *launcher_args,
               "--", sys.executable, str(tmp / "worker.py"), *worker_args,
               "--device", "cpu"]
        self.proc = subprocess.Popen(cmd, env=e, cwd=str(self.dir),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT)
        self.out = b""
        self.code = None

    def finish(self, timeout):
        try:
            self.out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.out, _ = self.proc.communicate()
        self.code = self.proc.returncode


def _flip_when(run, control, lines, timeout=150):
    """Create ``control`` once the log has ``lines`` rows (the scripted
    discovery schedule of the reference's integration tests)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and run.proc.poll() is None:
        if len(_rows(run.log)) >= lines:
            break
        time.sleep(0.05)
    open(control, "w").close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launcher")
    (tmp / "worker.py").write_text(WORKER)
    control = str(tmp / "shrink_now")
    runs = {
        "static": _Run(tmp, "static", ["-np", "2"], ["static"]),
        "shrink": _Run(tmp, "shrink",
                       ["--min-np", "1", "--max-np", "2",
                        "--host-discovery-script",
                        _discovery(tmp / "shrink.sh", control,
                                   "localhost:2", "localhost:1")],
                       ["elastic"]),
        "crash": _Run(tmp, "crash",
                      ["--min-np", "2", "--max-np", "2",
                       "--blacklist-cooldown", "1",
                       "--fault-plan", "crash@step=7:rank=1",
                       "--host-discovery-script",
                       _discovery(tmp / "crash.sh", control + ".never",
                                  "localhost:2", "localhost:2")],
                      ["elastic"],
                      env={"HVDT_FAULT_JOURNAL": str(tmp / "journal")}),
    }
    # >= 12 lines from 2 ranks == batch >= 6: past the first commit.
    flip = threading.Thread(target=_flip_when,
                            args=(runs["shrink"], control, 12))
    flip.start()
    for r in runs.values():
        r.finish(timeout=240)
    flip.join(timeout=10)
    spec = importlib.util.spec_from_file_location("worker",
                                                  tmp / "worker.py")
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    return runs, worker


def _ok(run):
    assert run.code == 0, run.out.decode(errors="replace")[-4000:]


def test_static_two_ranks(runs):
    run = runs[0]["static"]
    _ok(run)
    out = run.out.decode()
    for rank in (0, 1):
        assert f"rank {rank} of 2: [3.0, 3.0]" in out


def test_elastic_shrink_keeps_the_reference_log_contract(runs):
    run = runs[0]["shrink"]
    _ok(run)
    rows = _rows(run.log)
    assert {s for _, s, _, _, _ in rows} == {2, 1}
    first_one = next(b for _, s, b, _, _ in rows if s == 1)
    assert first_one > 1, "the shrunk world restarted from scratch"
    assert max(b for _, _, b, _, _ in rows) == TOTAL["shrink"]
    assert {r for r, s, _, _, _ in rows if s == 1} == {0}
    assert {lr for _, s, _, lr, _ in rows if s == 2} == {2 * BASE_LR_MILLI}
    assert {lr for _, s, _, lr, _ in rows if s == 1} == {BASE_LR_MILLI}
    last_old = max(ts for _, s, _, _, ts in rows if s == 2)
    first_new = min(ts for _, s, _, _, ts in rows if s == 1)
    assert 0 <= first_new - last_old < 90_000


def test_elastic_crash_respawns_and_matches_the_uninterrupted_run(runs):
    run, worker = runs[0]["crash"], runs[1]
    _ok(run)
    out = run.out.decode(errors="replace")
    assert "terminating generation 1 after rank 1 failed" in out
    rows = _rows(run.log)
    r1 = [b for r, _, b, _, _ in rows if r == 1]
    # Rank 1 died before batch 7; its new process resumed from the
    # batch-5 commit (batch 6 logged twice) and reached the target.
    assert r1[:6] == [1, 2, 3, 4, 5, 6] and max(r1) == TOTAL["crash"]
    assert r1[6] == 6, r1
    got = torch.load(run.state + ".final")
    want = worker.simulate(2, TOTAL["crash"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
