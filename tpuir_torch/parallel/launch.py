"""Start a world of processes on this host, one a rank, and collect what
each returns: the port's ``mp.spawn`` with a time limit.

    results = launch(fn, world_size=2, args=(...,), backend="gloo", device="cuda:0")

Each rank is a fresh ``spawn`` process that joins a group at a
``FileStore`` in a temporary directory (no TCP port to collide with another
world on the host), calls ``fn(*args)`` and sends back its result, which
must pickle by value: NumPy arrays and Python numbers, not CUDA tensors.
``fn`` must be importable from a module (it is pickled by name), and a
script that launches must guard its entry with ``if __name__ ==
"__main__"``, since each rank imports the script again. ``fn`` and
``args`` reach the ranks through a file in that directory, not the spawn
pipe, so that starting a rank never blocks on one stuck in its start-up.
A rank that raises fails the launch with its traceback at once; a rank
that dies without a word, or a world that outlives ``timeout``, fails it
too. The ranks left are killed either way, so no collective waits past
that.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from tpuir_torch.parallel.dist import destroy_dist, init_dist


def _run_rank(rank: int, world_size: int, store: str, backend: Optional[str], device,
              threads: Optional[int], job: str, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        with open(job, "rb") as f:
            fn, args = pickle.load(f)  # written by ``launch``
        init_dist(backend, rank, world_size, init_method=store, device=device)
        results.put((rank, True, fn(*args)))
    except Exception:  # noqa: BLE001 -- a rank's boundary: report it to the launcher
        results.put((rank, False, traceback.format_exc()))
    finally:
        destroy_dist()


def launch(fn: Callable, world_size: int, args: Sequence = (), backend: Optional[str] = None,
           device=None, timeout: float = 300.0, threads: Optional[int] = None) -> List:
    """Run ``fn(*args)`` on ``world_size`` ranks; their results by rank.

    ``device`` (every rank's; default ``cuda:rank``) and ``backend``
    (default NCCL on CUDA, gloo on the CPU) go to ``init_dist``, whose
    group has ``dist.TIMEOUT_S`` as its collective limit. ``threads`` sets
    torch's CPU threads in each rank. Raises ``RuntimeError`` for a failed
    rank and ``TimeoutError`` past ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tpuir_world_") as tmp:
        store = "file://" + os.path.join(tmp, "store")
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_run_rank, daemon=True,
                             args=(rank, world_size, store, backend, device, threads, job,
                                   results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done = {}
        try:
            while len(done) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"a world of {world_size} ran past {timeout:.0f} s; "
                                       f"ranks {sorted(set(range(world_size)) - set(done))} "
                                       "had not finished")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                done[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [done[r] for r in range(world_size)]
