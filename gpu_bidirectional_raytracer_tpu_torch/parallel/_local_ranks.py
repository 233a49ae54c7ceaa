"""Local ranks for the tests and the smoke script: a new process group of
processes on this machine, and the training step's tolerance.

Not an entry point: a run over several cards starts its ranks with
``torchrun`` and joins them with `distributed.initialize_cluster`. This
module starts the ranks itself so that one call can run a sharded
function on ``gloo`` ranks of the CPU or of one shared card and compare
their results with one process.
"""

from __future__ import annotations

import io
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gpu_bidirectional_raytracer_tpu_torch.core.types import resolve_device
from gpu_bidirectional_raytracer_tpu_torch.parallel.distributed import (
    initialize_cluster,
)

PARAMS = ("p", "rad", "e", "c")
# tests/test_parallel.py:296-304: the sharded step's loss within 1e-5 of
# one process's, each gradient within ``1e-4 |ref| + 1e-4 max|ref|``.
STEP_LOSS_ATOL, STEP_GRAD_RTOL = 1e-5, 1e-4


def free_port() -> int:
    """A TCP port on ``localhost`` that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world_size: int, port: int, device: str | None,
               fn: Callable, args: tuple, results) -> None:
    """One spawned rank: join the group as local rank ``rank`` with one
    intra-op thread, run ``fn(mesh, *args)``, send its result
    (`torch.save` bytes) or the traceback."""
    from gpu_bidirectional_raytracer_tpu_torch.parallel.mesh import make_mesh

    try:
        os.environ["LOCAL_RANK"] = str(rank)
        torch.set_num_threads(1)
        initialize_cluster(f"tcp://localhost:{port}", world_size, rank,
                           "gloo", device)
        out = fn(make_mesh(device=device), *args)
        buf = io.BytesIO()
        torch.save(out, buf)
        results.put((rank, True, buf.getvalue()))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), *,
                device: str | torch.device | None = None,
                timeout: float = 120.0) -> list:
    """``[fn(mesh, *args) of rank 0, ...]``: ``fn`` run on every rank of a
    new ``gloo`` group of ``world_size`` local processes (``spawn``),
    formed on ``tcp://localhost:<a free port>``. Each rank runs on
    ``device`` (default: ``cuda:<rank % card count>``, as ``torchrun``'s
    local ranks; without a card this raises before any process starts)
    with one intra-op thread; ``gloo`` lets several ranks share a card.
    ``fn`` must be importable by name (a module's top-level function);
    each result comes back through `torch.save`, its tensors on the CPU.

    Raises RuntimeError, after killing every rank still running, if a
    rank raises, exits before it reports, or the ranks have not all
    reported within ``timeout`` seconds."""
    resolve_device("cuda" if device is None else device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    dev = None if device is None else str(device)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, dev, fn, tuple(args),
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    ok = False
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise RuntimeError(f"ranks {missing} of {world_size} did not "
                                   f"finish within {timeout} s")
            try:
                rank, fine, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} exited with code "
                                           f"{p.exitcode} before it reported")
                continue
            if not fine:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n"
                                   f"{payload}")
            got[rank] = torch.load(io.BytesIO(payload), map_location="cpu",
                                   weights_only=False)
        ok = True
    finally:
        for p in procs:
            if ok:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        results.close()
    return [got[r] for r in range(world_size)]


def step_grads(loss: torch.Tensor, grads) -> dict:
    """A training step's ``(loss, Scene grads)`` as ``{"loss", "p", "rad",
    "e", "c"}``."""
    return {"loss": loss.detach(), **{k: getattr(grads, k) for k in PARAMS}}


def step_close(got: dict, ref: dict) -> dict:
    """`step_grads` results ``got`` against ``ref`` under
    tests/test_parallel.py's tolerances: the loss's absolute error, each
    gradient's largest absolute error, and ``ok``."""
    res = {"loss_abs_err": abs(float(got["loss"]) - float(ref["loss"]))}
    ok = res["loss_abs_err"] < STEP_LOSS_ATOL
    for k in PARAMS:
        a, b = ref[k].detach().cpu(), got[k].detach().cpu()
        scale = max(float(a.abs().max()), 1e-12)
        err = (a - b).abs()
        res[f"{k}_max_abs_err"] = float(err.max())
        ok = ok and bool((err <= STEP_GRAD_RTOL * a.abs()
                          + STEP_GRAD_RTOL * scale).all())
    res["ok"] = ok
    return res
