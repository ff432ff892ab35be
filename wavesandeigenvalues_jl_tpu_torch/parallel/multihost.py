"""Multi-process initialisation, the pod mesh, and a launcher for gloo
worlds.

Counterpart of the JAX package's ``parallel/multihost.py``:

* :func:`init_multihost` — ``torch.distributed.init_process_group`` when
  configured, a strict no-op otherwise.  Explicit arguments win; else the
  standard environment of ``torchrun`` (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, through ``env://``).  The JAX package
  reads its own ``WAE_*`` variables; the port reads none of them.  The
  backend is NCCL on CUDA (one rank per GPU), gloo on the CPU.
* :func:`pod_mesh` — one (host × shift × row) DeviceMesh over the world's
  ranks, the ``host`` axis following process placement so that the
  ``row`` halo exchanges and intra-solve sums stay inside a host and only
  the ``shift`` axis and the final moment sum cross hosts.
* :func:`pod_spec_check` — runs the per-axis sums with the pod layout's
  axis roles over a world of n ranks and returns the axis sizes.  The JAX
  package runs it in-process on its virtual CPU devices; here it runs on
  the current world when that has n ranks, else on n gloo processes it
  starts itself (:func:`run_world`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import all_reduce_sum, axis_size

#: the repository root (the port's parent directory), put on the
#: ``PYTHONPATH`` of the processes :func:`run_world` starts
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   timeout: Optional[float] = None) -> bool:
    """Initialise the default process group when configured; no-op
    otherwise.  Returns True when the world has more than one rank.

    ``coordinator`` ("host:port" of rank 0's store) with ``num_processes``
    and ``process_id`` wins; else torchrun's environment (all of
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` set);
    with neither nothing is touched.  On NCCL each rank takes the GPU
    ``LOCAL_RANK`` (torchrun) or its rank modulo the GPU count.
    ``timeout``: seconds a collective may wait."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: a coordinator needs "
                             "num_processes and process_id")
        kw.update(init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    elif all(v in os.environ for v in _TORCHRUN_ENV):
        kw["init_method"] = "env://"
        rank = int(os.environ["RANK"])
    else:
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)
    return dist.get_world_size() > 1


def pod_mesh(n_shift: Optional[int] = None, n_row: Optional[int] = None,
             ranks=None, device_type: Optional[str] = None):
    """(host × shift × row) DeviceMesh over the world's ranks.

    ``n_shift``/``n_row`` split the PER-HOST ranks (their product must
    equal the per-host rank count; default: all per-host ranks on the row
    axis).  ``ranks``: an explicit [n_host, per_host] grid of ranks; by
    default the world's ranks in order, ``LOCAL_WORLD_SIZE`` (torchrun)
    of them a host.  ``device_type``: "cuda" on NCCL, else "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh
    if ranks is not None:
        grid = np.asarray(ranks)
        grid = grid.reshape(grid.shape[0] if grid.ndim == 2 else 1, -1)
    else:
        world = dist.get_world_size() if dist.is_initialized() else 1
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        grid = np.arange(world).reshape(-1, per_host)
    n_host, per_host = grid.shape
    if n_row is None and n_shift is None:
        n_shift, n_row = 1, per_host
    elif n_row is None:
        n_row = per_host // n_shift
    elif n_shift is None:
        n_shift = per_host // n_row
    if n_shift * n_row != per_host:
        raise ValueError(f"shift×row = {n_shift}×{n_row} != per-host "
                         f"rank count {per_host}")
    if device_type is None:
        device_type = ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type,
                      torch.as_tensor(grid.reshape(n_host, n_shift, n_row)),
                      mesh_dim_names=("host", "shift", "row"))


def _pod_program(n_host: int) -> dict:
    """The pod layout's per-axis sums on the current world of n ranks:
    row = an intra-solve dot product, shift = the free axis, host = the
    final moment sum; each checked against numpy.  Returns the axis
    sizes."""
    n = dist.get_world_size()
    n_shift = 2 if n // n_host >= 2 else 1
    n_row = n // n_host // n_shift
    mesh = pod_mesh(n_shift=n_shift, n_row=n_row,
                    ranks=np.arange(n).reshape(n_host, -1))
    sizes = {a: axis_size(mesh, a) for a in ("host", "shift", "row")}
    coord = {a: mesh.get_local_rank(a) for a in sizes}
    m = 16
    x = np.arange(m * sizes["row"], dtype=np.float64)
    s = np.arange(4 * sizes["shift"], dtype=np.float64)
    h = np.arange(4 * sizes["host"], dtype=np.float64)
    for axis, full, f in (("row", x, lambda v: (v * v).sum()),
                          ("shift", s, np.sum), ("host", h, np.sum)):
        k, size = coord[axis], sizes[axis]
        share = full.reshape(size, -1)[k]
        got = all_reduce_sum(torch.tensor(f(share)), mesh, axis).item()
        if not np.isclose(got, f(full), rtol=1e-12):
            raise RuntimeError(f"pod mesh axis {axis}: sum {got}, expected "
                               f"{f(full)}")
    return sizes


def pod_spec_check(n_devices: int, n_host: int = 2) -> dict:
    """Run the (host × shift × row) sums of the pod layout over
    ``n_devices`` ranks: on the current world when it has that many,
    else on as many gloo processes started here.  Returns the axis sizes
    checked."""
    if dist.is_initialized() and dist.get_world_size() == n_devices:
        return _pod_program(n_host)
    return run_world(f"{__name__}:_pod_program", n_devices, (n_host,))[0]


def run_world(target: str, n: int, args=(), timeout: float = 300.0,
              sys_path=()) -> list:
    """Run ``target`` ("module:function") with ``args`` on n gloo
    processes joined in one world (a FileStore in a temporary directory,
    collectives timing out after 60 s), and return each rank's result in
    rank order.  ``sys_path``: directories the processes import from
    first.  Raises RuntimeError with a failed rank's output; kills every
    process it started before it returns or raises."""
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump((target, tuple(args), list(sys_path)), f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        code = ("import sys; from wavesandeigenvalues_jl_tpu_torch.parallel."
                "multihost import _world_main; _world_main(*sys.argv[1:])")
        logs = [open(os.path.join(tmp, f"log_{r}.txt"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, tmp, str(n), str(r)], env=env,
            stdout=log, stderr=subprocess.STDOUT) for r, log in
            enumerate(logs)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"run_world({target!r}, {n}): timed out "
                               f"after {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(tmp, f"log_{r}.txt")) as f:
                    out = f.read()
                raise RuntimeError(f"run_world({target!r}, {n}): rank {r} "
                                   f"exited {p.returncode}:\n{out[-4000:]}")
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _world_main(tmp: str, n: str, rank: str):
    """One process of :func:`run_world`."""
    import importlib
    n, rank = int(n), int(rank)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        target, args, paths = pickle.load(f)
    sys.path[:0] = paths
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group("gloo", store=store, world_size=n, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        module, name = target.split(":")
        out = getattr(importlib.import_module(module), name)(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


__all__ = ["init_multihost", "pod_mesh", "pod_spec_check", "run_world"]
