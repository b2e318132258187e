"""Spawn a ``torch.distributed`` world of local processes and run port
functions in every rank: the port's counterpart of XLA's virtual devices.

:func:`run_world` starts ``n`` processes (start method ``spawn``) that meet
through a ``file://`` store in a temporary directory, builds each rank's
:class:`~.mesh.DeviceMesh`, runs a list of named functions of this package
in order (each gets the mesh first) and returns every rank's results.

The backend is chosen from the device and printed, never switched on an
error:

- ``gloo`` on the CPU;
- ``nccl`` when every rank has a card of its own (rank ``r`` on ``cuda:r``);
- ``gloo`` when ranks share cards (rank ``r`` on ``cuda:(r % count)``):
  NCCL refuses two ranks on one device, and gloo takes CUDA tensors for
  ``all_reduce`` and ``all_gather``.

Every wait has a deadline: a rank that raises or a world that hangs (a
collective that some rank never joins) makes :func:`run_world` kill the
world and raise. The CUDA kernels are built by the caller
(``csrc/build.py::load_kernels``) before the ranks start, so that the ranks
only load them. Run with ``python -m rovinasemanticsegmentation_tpu_torch.parallel.dryrun``
for the dry run.
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

_PACKAGE = __name__.split(".")[0]
_CALLS = "calls.pkl"


@dataclass
class Call:
    """``fn`` (``"module:function"`` of this package, the module relative to
    it, e.g. ``"parallel.mesh:shard_batch_pipeline"``) called as
    ``fn(mesh, *args, **kwargs)`` in every rank."""

    fn: str
    args: Sequence[Any] = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)


def choose_backend(device_type: str, n_ranks: int) -> str:
    if device_type == "cpu":
        return "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA world requested but "
                               "torch.cuda.is_available() is False")
        return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    raise ValueError(f"unsupported device {device_type!r}; use cpu or cuda")


def rank_device(device_type: str, rank: int) -> torch.device:
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _resolve(name: str):
    module, _, fn = name.partition(":")
    return getattr(importlib.import_module(f"{_PACKAGE}.{module}"), fn)


def _rank_main(rank: int, n: int, tmp: str, backend: str, device_type: str,
               timeout_s: float, threads: int, out) -> None:
    """One rank: join the world, build the mesh, run the calls, report."""
    from ..device import resolve_device
    from .mesh import make_mesh

    try:
        with open(os.path.join(tmp, _CALLS), "rb") as f:
            calls = pickle.load(f)  # written by run_world
        torch.set_num_threads(threads)
        dev = rank_device(device_type, rank)
        if dev.type == "cuda":
            dev = resolve_device(dev)
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            mesh = make_mesh(n, device=dev)
            results = [_resolve(c.fn)(mesh, *c.args, **c.kwargs) for c in calls]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, results))
    except Exception:  # report to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_world(
    n_ranks: int,
    calls: Sequence[Call],
    device: str = "cuda",
    timeout: float = 120.0,
) -> List[List[Any]]:
    """Run ``calls`` in a world of ``n_ranks`` processes on ``device``
    (``"cuda"``, which raises where there is no card, or ``"cpu"``);
    -> ``results[rank][call]``.

    Raises if a rank raises, or if the world has not finished ``timeout``
    seconds after it was started (the deadline covers start-up,
    ``init_process_group`` and every collective).
    """
    backend = choose_backend(device, n_ranks)
    where = "cpu" if device == "cpu" else (
        f"{torch.cuda.device_count()} card(s), "
        + ("one per rank" if backend == "nccl" else "shared by the ranks"))
    print(f"world: {n_ranks} ranks, backend {backend}, {where}", flush=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rovina_world_")
    # The calls' arguments go through a file: a process's start blocks while
    # its arguments fill the pipe and the child is still importing torch.
    with open(os.path.join(tmp, _CALLS), "wb") as f:
        pickle.dump(list(calls), f)
    threads = max(1, (os.cpu_count() or 1) // n_ranks)
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(r, n_ranks, tmp, backend, device, timeout, threads, out),
            daemon=True,
        )
        for r in range(n_ranks)
    ]
    deadline = time.monotonic() + timeout
    results: Dict[int, List[Any]] = {}
    try:
        for p in procs:
            p.start()
        while len(results) < n_ranks:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {n_ranks} ranks did not finish in {timeout} s; "
                    f"ranks {sorted(set(range(n_ranks)) - set(results))} "
                    "missing")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead and out.empty():
                    raise RuntimeError(
                        f"rank(s) {dead} exited with codes "
                        f"{[procs[r].exitcode for r in dead]} without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n_ranks)]


def launch_counts(mesh) -> Dict[str, int]:
    """This rank's launch counts of kernels A (and its Lab pack) and B."""
    from ..ops import forest_cuda, patches_cuda

    return {
        "pack_lab": patches_cuda.pack_launches.value,
        "patches": patches_cuda.launches.value,
        "forest_descent": forest_cuda.launches.value,
    }


def reset_launch_counts(mesh) -> None:
    from ..ops import forest_cuda, patches_cuda

    for counter in (patches_cuda.pack_launches, patches_cuda.launches,
                    forest_cuda.launches):
        counter.reset()


def loaded_modules(mesh) -> List[str]:
    """The names of the modules loaded in this rank (the import checks)."""
    import sys

    return sorted(sys.modules)
