"""Start N ranks of a parallel run on one host, one process each.

``launch(fn, nprocs, backend=..., devices=...)`` spawns one process per
rank, joins them into one ``torch.distributed`` world through a
``FileStore`` in a fresh temporary directory (no TCP port to choose, so
concurrent launches never collide), calls ``fn(ctx, *args, **kwargs)`` in each and
returns the ranks' results in rank order.

The backend and each rank's device are explicit arguments, never guessed:
``nccl`` where every rank has its own card, ``gloo`` on the CPU and for
ranks that share one card. A rank that raises makes ``launch`` raise with
its traceback; the parent then kills the ranks still running (they would
wait on the failed rank's collectives), as it does at the timeout.

``spawn`` imports ``fn``'s module in every child, so a rank body lives in
a module that imports no JAX (``parallel/workers.py``), never in a test
module that does. A multi-host run starts its ranks with ``torchrun`` and
``dcn.init_distributed`` instead.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a rank body is told: its rank, the world size, its device and
    the backend."""
    rank: int
    world: int
    device: torch.device
    backend: str


def _child(fn, rank: int, world: int, backend: str, device: str,
           store_path: str, out_dir: str, threads: int, args,
           kwargs) -> None:
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        out = fn(RankContext(rank, world, dev, backend), *args, **kwargs)
        path, payload = f"rank{rank}.out", out
    except Exception:  # a rank's failure goes to the parent, which raises
        path, payload = f"rank{rank}.err", traceback.format_exc()
    with open(os.path.join(out_dir, path + ".tmp"), "wb") as f:
        pickle.dump(payload, f)
    os.replace(os.path.join(out_dir, path + ".tmp"),
               os.path.join(out_dir, path))
    if path.endswith(".err"):
        os._exit(1)     # no teardown: the other ranks may be mid-collective
    dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *, backend: str,
           devices: Sequence[str], args: tuple = (),
           kwargs: Optional[dict] = None, timeout: float = 600.0,
           threads: int = 1) -> list:
    """Run ``fn(ctx, *args, **kwargs)`` on ``nprocs`` ranks; returns their
    results in rank order. ``devices[r]`` is rank r's device ("cpu", "cuda:0", ...);
    ``threads`` is each rank's torch thread count. Raises RuntimeError with
    the first failing rank's traceback, TimeoutError after ``timeout``
    seconds; either way no rank is left running."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', not {backend!r}")
    if len(devices) != nprocs:
        raise ValueError(f"{nprocs} ranks need {nprocs} devices, got "
                         f"{len(devices)}")
    if backend == "nccl" and len(set(devices)) != nprocs:
        raise ValueError("nccl needs one card per rank; ranks that share a "
                         "card run over gloo")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pqc_launch_")
    procs = []
    try:
        for r in range(nprocs):
            p = ctx.Process(target=_child, args=(
                fn, r, nprocs, backend, str(devices[r]),
                os.path.join(tmp, "store"), tmp, threads, args,
                kwargs or {}))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if failed:
            r = failed[0]
            err = os.path.join(tmp, f"rank{r}.err")
            msg = f"exit code {procs[r].exitcode}"
            if os.path.exists(err):
                with open(err, "rb") as f:
                    msg = pickle.load(f)
            raise RuntimeError(f"rank {r} of {nprocs} failed:\n{msg}")
        out = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
