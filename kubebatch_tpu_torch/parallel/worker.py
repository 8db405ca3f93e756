"""Solver workers: the ranks > 0 of a node mesh.

Rank 0 is the scheduler process: it holds the session and the
DeviceSession and calls the sharded engines
(kernels/batched_sharded.py ``solve_batched_sharded``, kernels/hier.py
``solve_hier_sharded``, kernels/sharded.py ``build_sharded_allocate``).
Every other rank runs :func:`serve`: it waits for a solve header from rank 0, receives its
node block and the replicated arrays, runs its part of the solve on its
own device, replies with its counts, and returns on a shutdown message.

:func:`main` is the spawn target (``main(rank, world, init_file,
device)``): it lives in the port so that a spawned child imports the port
only, joins the group over a ``FileStore`` (no network), serves, and
leaves the group. :func:`launch` is what a caller on rank 0 calls to
spawn the workers and join them itself. Process-group init and every
wait have a finite timeout, so a hung rank fails its run instead of
hanging it.
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import List

#: seconds a rank waits at init or for a collective (a header included)
#: before it fails
DEFAULT_TIMEOUT = 600.0


def serve(mesh) -> int:
    """Serve rank 0's requests until it sends ``shutdown``. Returns the
    number of solves served."""
    from ..kernels import batched_sharded, sharded

    served = 0
    while True:
        header, block = mesh.send_objects()
        op = header["op"]
        if op == "shutdown":
            return served
        if op == "status":
            mesh.gather_objects(status())
        elif op in ("batched", "hier"):
            solve = (batched_sharded.solve_hier_rank if op == "hier"
                     else batched_sharded.solve_rank)
            stats = solve(mesh, block, header["rep"], header["statics"],
                          header["n_sh"], header["check"])[3]
            mesh.gather_objects(stats)
        elif op == "scan":
            mesh.gather_objects(sharded.scan_worker(mesh, header, block))
        else:
            raise ValueError(f"solver worker: unknown op {op!r}")
        served += 1


def status() -> dict:
    """This process's facts for rank 0: its pid and whether the JAX
    package or the reference package is imported (a worker must import
    the port only)."""
    return {"pid": os.getpid(), "jax": "jax" in sys.modules,
            "kubebatch_tpu": "kubebatch_tpu" in sys.modules}


def request_status(mesh) -> List[dict]:
    """Every rank's :func:`status`, from rank 0."""
    mesh.send_objects({"op": "status"}, [None] * mesh.world)
    return mesh.gather_objects(status())


def shutdown(mesh) -> None:
    """Rank 0: end every worker's :func:`serve`."""
    if mesh.world > 1:
        mesh.send_objects({"op": "shutdown"}, [None] * mesh.world)


def _init(rank: int, world: int, init_file: str, timeout: float) -> None:
    import torch.distributed as dist

    store = dist.FileStore(init_file, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))


def main(rank: int, world: int, init_file: str, device: str,
         timeout: float = DEFAULT_TIMEOUT) -> None:
    """Spawn target of a solver worker: join the group, serve, leave."""
    import torch
    import torch.distributed as dist

    from .mesh import node_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    else:
        # k ranks share the host's cores with whatever else runs there
        torch.set_num_threads(1)
    _init(rank, world, init_file, timeout)
    try:
        serve(node_mesh(device=dev))
    finally:
        dist.destroy_process_group()


class Launched:
    """Rank 0 of a group :func:`launch` made: ``mesh`` and the worker
    processes; :meth:`close` shuts the workers down, joins them and
    leaves the group."""

    def __init__(self, mesh, procs):
        self.mesh, self.procs = mesh, procs

    def close(self, timeout: float = 60.0) -> None:
        import torch.distributed as dist

        try:
            shutdown(self.mesh)
        finally:
            for p in self.procs:
                p.join(timeout)
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            dist.destroy_process_group()
        bad = [p.exitcode for p in self.procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"solver workers exited with {bad}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch(world: int, init_file: str, device: str = "cuda",
           timeout: float = DEFAULT_TIMEOUT) -> Launched:
    """Spawn ``world - 1`` solver workers on ``device`` (k ranks may
    share one card), join the group as
    rank 0 over a ``FileStore`` at ``init_file`` (a path no other group
    uses), and return the :class:`Launched` group with rank 0's mesh.
    The caller owns it: :meth:`Launched.close` ends it."""
    import multiprocessing as mp

    from .mesh import node_mesh

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=main, args=(r, world, init_file, device,
                                            timeout), daemon=True)
             for r in range(1, world)]
    for p in procs:
        p.start()
    # join on a thread and watch the workers: one that dies before the
    # group forms fails the launch now, not at the init timeout
    failed = []

    def join():
        try:
            _init(0, world, init_file, timeout)
        except BaseException as e:              # reraised below
            failed.append(e)

    t = threading.Thread(target=join, daemon=True)
    t.start()
    while t.is_alive():
        t.join(0.2)
        dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        if dead and t.is_alive():
            failed.append(RuntimeError(f"solver workers exited with {dead} "
                                       f"before the group formed"))
            break
    if failed:
        for p in procs:
            p.kill()
        raise failed[0]
    return Launched(node_mesh(device=device), procs)
