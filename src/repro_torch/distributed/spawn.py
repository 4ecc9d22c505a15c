"""Start the ranks of a sharded run, one process each (PyTorch).

``run_ranks(fn, n, *args, backend=, device=, timeout_s=)`` starts ``n``
processes with the ``spawn`` start method (``fork`` would copy the
parent's CUDA state and threads), builds the shard mesh in each
(``launch.mesh.make_shard_mesh``, rendezvous through a file in a
temporary directory, so concurrent runs never contend for a port), calls
``fn(mesh, *args)`` there and returns the ranks' return values in rank
order.  ``fn`` and ``args`` go to the ranks and their values come back
through files, pickled.

``fn`` and ``args`` are pickled, so ``fn`` must be importable by name (a
module-level function).  Each rank runs on one intra-op thread
(``torch.set_num_threads(1)``): the CPU plain versions need it for
bitwise parity, and n ranks on a shared host should not each spread over
every core.

When a rank fails (an exception, a signal) or the deadline passes, every
rank is killed and ``run_ranks`` raises with the failed ranks' tracebacks
and exit codes (after a failure the ranks get ``FAILURE_GRACE_S`` to
report or exit, so the peers a dead rank takes down do not hide it); no
process outlives the call.  ``torchrun --nproc-per-node n`` is the
other way to start the ranks: each then calls ``make_shard_mesh()``.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional

__all__ = ["run_ranks", "RankFailed"]

FAILURE_GRACE_S = 1.0


class RankFailed(RuntimeError):
    """A rank raised, died or outlived ``run_ranks``' deadline; ``pids``
    are the ranks' process ids (all of them killed and reaped)."""

    def __init__(self, message: str, pids: List[int]):
        super().__init__(message)
        self.pids = pids


def _rank_main(rank: int, n: int, backend, device, rendezvous,
               timeout_s: float, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
    err = os.path.join(out_dir, f"rank-{rank}.err")

    def report():
        # before the group is torn down, so the first failure's report
        # is older than the peers' it causes
        if not os.path.exists(err):
            with open(err + ".tmp", "w") as f:
                f.write(traceback.format_exc())
            os.replace(err + ".tmp", err)

    try:
        import torch
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_shard_mesh

        torch.set_num_threads(1)
        with open(os.path.join(out_dir, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        mesh = make_shard_mesh(n, backend=backend, device=device,
                               init_method=rendezvous, timeout_s=timeout_s)
        try:
            out = fn(mesh, *args)
        except BaseException:
            report()
            raise
        finally:
            dist.destroy_process_group()
        tmp = os.path.join(out_dir, f"rank-{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(out_dir, f"rank-{rank}.pkl"))
    except BaseException:
        report()
        raise


def _failure(procs, out_dir: str) -> Optional[str]:
    """The failed ranks' reports, the earliest first, or None while no
    rank has failed (a rank fails once it reports or exits non-zero)."""
    failed = []
    for r, p in enumerate(procs):
        err = os.path.join(out_dir, f"rank-{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                failed.append((os.stat(err).st_mtime_ns, r, f.read()))
        elif p.exitcode not in (None, 0):
            failed.append((time.time_ns(), r, f"exit code {p.exitcode}"))
    if not failed:
        return None
    return "\n".join(f"rank {r} of {len(procs)} failed:\n{text}"
                     for _, r, text in sorted(failed))


def run_ranks(fn: Callable[..., Any], n: int, *args, backend: Optional[str]
              = None, device=None, timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` ranks and return their values.

    ``backend``/``device`` go to ``make_shard_mesh`` in every rank (its
    defaults: each rank on ``cuda:{rank % device_count}``, NCCL).  Several
    ranks share one card with ``backend="gloo"``; ``device="cpu"`` runs
    them on the CPU.  ``timeout_s`` bounds the whole run, process start
    included, and is each rank's process-group timeout too.
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as out_dir:
        rendezvous = "file://" + os.path.join(out_dir, "rendezvous")
        # the job goes through a file: a process's start blocks while it
        # writes the pickled target to the child's pipe, for good if the
        # child dies before reading more than the pipe holds
        with open(os.path.join(out_dir, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, name=f"rank-{r}",
                             args=(r, n, backend, device, rendezvous,
                                   timeout_s, out_dir),
                             daemon=True)
                 for r in range(n)]
        deadline = time.monotonic() + float(timeout_s)
        try:
            for p in procs:
                p.start()
            while True:
                failed = _failure(procs, out_dir)
                if failed is not None:
                    # a rank that dies takes its peers' collectives down
                    # with it: give every rank a moment to report or exit
                    # (the parent sees an exit only once it reaps it), so
                    # the report names every failed rank
                    grace = time.monotonic() + FAILURE_GRACE_S
                    for p in procs:
                        p.join(max(0.0, grace - time.monotonic()))
                    raise RankFailed(_failure(procs, out_dir),
                                     [p.pid for p in procs])
                alive = [p for p in procs if p.exitcode is None]
                if not alive:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RankFailed(
                        f"{len(alive)} of {n} ranks still running after "
                        f"{timeout_s} s: "
                        f"{', '.join(p.name for p in alive)}",
                        [p.pid for p in procs])
                mp.connection.wait([p.sentinel for p in alive],
                                   timeout=min(left, 1.0))
            out = []
            for r in range(n):
                with open(os.path.join(out_dir, f"rank-{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join()
