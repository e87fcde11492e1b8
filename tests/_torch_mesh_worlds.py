"""Process worlds for the port's sharded tests.

`spawn(case, world, args)` (or `World(...)`, then `.result()`, to work
while the world runs) starts `world` fresh Python processes, each a
rank of one gloo process group on the CPU (rendezvous through a file, so
no port is chosen), runs `case(rank, world, args)` — a function of
`_torch_mesh_cases` — in every rank, and returns rank 0's result. The whole world has
one deadline: a hung rendezvous or collective kills every rank and fails
the caller instead of hanging the test run.

A case builds its own mesh over the group; each one runs every check of
its test file, so that a file pays for one world's start-up (each rank
imports torch and torch.distributed.tensor, ~3 s). Each rank runs one
thread at `nice` 19, beside the test run's other workers.
"""
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def spawn(case: str, world: int, args: dict, timeout: float = 300.0):
    """Rank 0's return value of `case` run on `world` ranks."""
    return World(case, world, args).result(timeout)


class World:
    """`world` processes running `case`, started at once; `result`
    waits for them (the caller may work meanwhile)."""

    def __init__(self, case: str, world: int, args: dict):
        self.case, self.world = case, world
        self.tmp = tempfile.mkdtemp(prefix="mesh_world_")
        self.start = time.monotonic()
        with open(os.path.join(self.tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
                   OMP_NUM_THREADS="1")
        self.procs, self.logs = [], []
        for rank in range(world):
            log = open(os.path.join(self.tmp, f"rank{rank}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(rank),
                 str(world), self.tmp], env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def result(self, timeout: float = 300.0):
        """Rank 0's result; every rank killed and RuntimeError once
        `timeout` seconds have passed since the start, or on a failed
        rank."""
        try:
            deadline = self.start + timeout
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
            hung = [p for p in self.procs if p.poll() is None]
            for p in hung:
                p.kill()
                p.wait()
            failed = [(r, p.returncode) for r, p in enumerate(self.procs)
                      if p.returncode != 0]
            if hung or failed:
                tails = []
                for r, log in enumerate(self.logs):
                    log.seek(0)
                    tails.append(f"--- rank {r} ---\n{log.read()[-3000:]}")
                what = f"timed out after {timeout:.0f} s" if hung \
                    else f"failed: {failed}"
                raise RuntimeError(f"world {self.case!r} of {self.world} "
                                   f"{what}\n" + "\n".join(tails))
            with open(os.path.join(self.tmp, "out.pkl"), "rb") as f:
                return pickle.load(f)
        finally:
            for log in self.logs:
                log.close()
            shutil.rmtree(self.tmp, ignore_errors=True)


def _main(case: str, rank: int, world: int, tmp: str):
    # one thread a rank, at a lower priority: wall-time tests run beside
    # the world on the other test workers
    os.nice(19)
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import process_group
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    import _torch_mesh_cases as cases
    with process_group(world, rank, device="cpu",
                       init_method=f"file://{tmp}/rendezvous"):
        out = getattr(cases, case)(rank, world, args)
    if rank == 0:
        with open(os.path.join(tmp, "out.pkl"), "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
