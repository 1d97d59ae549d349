"""Run one SPMD function on spawned ranks of a process group.

The JAX package runs its multi-device solvers inside one process, on a
``Mesh`` of (real or virtual) devices.  In PyTorch the same program is
one process per rank on a ``torch.distributed`` process group.
:func:`run_ranks` starts ``world`` processes with the ``spawn`` start
method, joins them into a gloo group through a ``FileStore`` in a fresh
directory (no port is chosen, so concurrent runs cannot collide), calls
``fn(rank, world, *args)`` in each and returns their results.

A rank that raises, or a run that outlasts ``timeout``, ends every rank
and raises here: the parent polls the ranks and terminates the others
as soon as one exits with an error, so no rank is left blocked in a
collective.  The process group's own timeout is ``timeout`` too.
"""

from __future__ import annotations

import datetime
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch

__all__ = ["run_ranks"]


def _rank_main(rank, world, store, outdir, fn, args, timeout, threads):
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(int(threads))
    os.environ.setdefault("LOCAL_RANK", str(rank))
    status = 1
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        status = 0
    except BaseException:  # reported to the parent, then the rank exits 1
        with open(os.path.join(outdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(status)


def run_ranks(fn, world, args=(), timeout=120.0, threads=None):
    """``fn(rank, world, *args)`` on ``world`` spawned gloo ranks (several
    may share one card; one rank a card on NCCL is ``torchrun``'s).

    Args:
        fn: a module-level function (the ranks import it by name).
        timeout: seconds for the whole run, and the process group's
            collective timeout.
        threads: torch intra-op threads per rank (None: torch's default).

    Returns:
        The list of the ranks' return values, by rank.

    Raises:
        RuntimeError: a rank raised or exited without a result (its
            traceback is in the message), or the run timed out.
    """
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="pyfem_ranks_")
    store = os.path.join(run_dir, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, run_dir, fn, tuple(args),
                               float(timeout), threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + float(timeout)
        failed = timed_out = False
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = True
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(run_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if timed_out:
            errors.insert(0, f"ranks timed out after {timeout} s")
        if errors or failed:
            raise RuntimeError("\n".join(errors) or "a rank failed")
        return [torch.load(os.path.join(run_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
