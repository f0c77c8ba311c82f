"""A cell on several cards: one rank a card, each its own process, under
the run's process.

``run`` starts the cell's ``chips`` ranks (``python3 -m splatbench.ranks``,
one process each, their standard output sent to standard error) and gives
each a ``torch.distributed`` default group over
``tcp://127.0.0.1:<free port>``: NCCL with rank r on ``cuda:r`` (gloo on
the CPU, for the tests), as ``websplat_tpu_torch/parallel/dryrun.py``
does; the program takes its group from it
(``parallel/group.py:device_group``).  Each rank checks for forbidden
modules at its start and end, makes the run's set-up on its own card,
waits for the slowest rank, runs the window and judges its own frames
(``run.run_rank``), and sends what it measured and its verdict back over
its socket; the run's process, which touches no card, combines them
(``run.result_of``) and prints.  Rank 0 ends the window on its clock and
names the last step on a page the ranks share, which the others read with
no system call (``drivers.Lead``, ``drivers.Follow``).

No hang: the run's process waits on every rank's socket at once.  A rank
that raises, or ends without its result (its socket closes), or a run
that passes ``seconds + WAIT_S`` has every rank killed at once, and
``run`` raises ``RankFailed``: nothing is printed to standard output, and
a killed process leaves nothing on its card.  A collective waits at most
``COLLECTIVE_S`` before it fails its rank.
"""

from __future__ import annotations

import time

T_RANK = time.perf_counter()  # a rank's process start, near enough

import datetime  # noqa: E402
import mmap  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from multiprocessing import connection  # noqa: E402
from typing import List  # noqa: E402

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
WAIT_S = 300.0  # what a run may take beyond its window: set-up, the check
COLLECTIVE_S = 120.0
JOIN_S = 30.0  # a rank's exit after it has sent its result
BOARD_BYTES = 16  # the shared page: the window's number, the last step


class RankFailed(RuntimeError):
    """A rank raised, ended without its result, or outlived the run."""


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Link:
    """One rank's place among the others: its rank, and the page that rank
    0 names each window's last step on (``fd``: a shared file of
    ``BOARD_BYTES``, mapped here)."""

    def __init__(self, rank: int, fd: int):
        self.rank, self.windows = rank, 0
        self.board = mmap.mmap(fd, BOARD_BYTES)
        os.close(fd)

    def stop(self, seconds: float):
        from splatbench import drivers

        self.windows += 1
        if self.rank == 0:
            return drivers.Lead(seconds, self.board, self.windows)
        return drivers.Follow(self.board, self.windows)

    def latest(self, t: float, dev) -> float:
        """The latest of every rank's ``t`` (one all_reduce; it also lines the
        ranks up)."""
        import torch
        import torch.distributed as dist

        x = torch.tensor([t], dtype=torch.float64, device=dev)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x.item())

    def any(self, flag: bool, dev) -> bool:
        """Whether ``flag`` holds on any rank."""
        return self.latest(float(flag), dev) > 0


def rank_main(up: connection.Connection, board_fd: int) -> None:
    """One rank: its arguments come first over ``up``, its result or its
    traceback goes back over it; ``board_fd``: the shared page's file."""
    from splatbench import run

    try:
        found = run.forbidden_modules()
        if found:
            raise RuntimeError(f"loaded at start: {found}")
        a = up.recv()
        rank, device = a["rank"], a["device"]
        marks = [("start", a["t_start"]), ("the run's imports and spawn", a["t_spawn"]),
                 ("rank process", T_RANK)]
        import torch
        import torch.distributed as dist

        marks.append(("torch import", time.perf_counter()))
        dev = torch.device("cpu")
        if device == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(1)
        else:
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        marks.append(("set device", time.perf_counter()))
        dist.init_process_group(BACKENDS[device], init_method=f"tcp://127.0.0.1:{a['port']}",
                                rank=rank, world_size=a["size"],
                                timeout=datetime.timedelta(seconds=COLLECTIVE_S))
        marks.append(("process group", time.perf_counter()))
        if a["patch"] is not None:
            a["patch"]()
        out = run.run_rank(a["cell"], a["seed"], a["seconds"], a["trace_on"], dev, a["t_start"],
                           Link(rank, board_fd), marks)
        found = run.forbidden_modules()
        if found:
            raise RuntimeError(f"loaded by the run: {found}")
        up.send(("ok", out))
    except BaseException:  # reported to the run's process, which stops every rank
        try:
            up.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    dist.destroy_process_group()


class Ranks:
    """The cell's ranks, started at once (``patch``: a picklable function
    each calls before its set-up; the tests break the timed path with it).
    ``wait`` returns their ``run.RankOut``s in rank order; ``stop`` kills
    what is left."""

    def __init__(self, cell, seed: int, seconds: float, trace_on: bool, device: str,
                 t_start: float, patch=None):
        from splatbench import registry

        if device not in BACKENDS:
            raise ValueError(f"unsupported device {device!r}: 'cuda' (NCCL) or 'cpu' (gloo)")
        self.n, self.seconds, self.procs, self.ups = cell.chips, seconds, [], []
        t_spawn = time.perf_counter()
        port = free_port()
        with tempfile.TemporaryFile() as board:
            board.truncate(BOARD_BYTES)
            try:
                for r in range(self.n):
                    mine, theirs = socket.socketpair()
                    with theirs:
                        self.procs.append(subprocess.Popen(
                            [sys.executable, "-m", "splatbench.ranks", str(theirs.fileno()),
                             str(board.fileno())],
                            pass_fds=[theirs.fileno(), board.fileno()], cwd=registry.ROOT,
                            stdin=subprocess.DEVNULL, stdout=2))
                    self.ups.append(connection.Connection(mine.detach()))
                    self.ups[-1].send(dict(rank=r, size=self.n, port=port, device=device,
                                           cell=cell, seed=seed, seconds=seconds,
                                           trace_on=trace_on, t_start=t_start, t_spawn=t_spawn,
                                           patch=patch))
            except BaseException:
                self.stop()
                raise

    def wait(self) -> List:
        try:
            outs = {}
            pending = {up: r for r, up in enumerate(self.ups)}
            deadline = time.monotonic() + self.seconds + WAIT_S
            while pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankFailed(f"ranks {sorted(pending.values())} gave no result in "
                                     f"{self.seconds + WAIT_S:.0f} s")
                for up in connection.wait(list(pending), timeout=min(left, 5.0)):
                    r = pending.pop(up)
                    try:
                        kind, value = up.recv()
                    except EOFError:
                        try:
                            code = self.procs[r].wait(5.0)
                        except subprocess.TimeoutExpired:
                            code = "still running"
                        raise RankFailed(f"rank {r} ended ({code}) with no result") from None
                    if kind != "ok":
                        raise RankFailed(f"rank {r} failed:\n{value}")
                    outs[r] = value
            for r, p in enumerate(self.procs):
                try:
                    p.wait(JOIN_S)
                except subprocess.TimeoutExpired:  # killed below: its result stands
                    print(f"splatbench: rank {r} did not exit in {JOIN_S:.0f} s after its "
                          "result; killed", file=sys.stderr)
        finally:
            self.stop()
        return [outs[r] for r in range(self.n)]

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for up in self.ups:
            up.close()


def run(cell, seed: int, seconds: float, trace_on: bool, device: str, t_start: float,
        patch=None) -> List:
    """The cell's ranks' ``run.RankOut``s, in rank order."""
    return Ranks(cell, seed, seconds, trace_on, device, t_start, patch).wait()


if __name__ == "__main__":
    rank_main(connection.Connection(int(sys.argv[1])), int(sys.argv[2]))
