"""Process-group start-up for multi-rank training.

Counterpart of `splendax/parallel/multihost.py`.  Every rank runs the same
program: call `init_multihost()` first, then build the mesh with
`global_mesh()` (`mesh.make_mesh`).  Unlike JAX, where GSPMD places global
arrays and inserts the collectives, each rank here holds its own shard of
the training state and the port's code calls every collective itself
(`collectives`).

Launch with torchrun, which sets `MASTER_ADDR`, `MASTER_PORT`,
`WORLD_SIZE`, `RANK` and `LOCAL_RANK`:

    torchrun --nproc-per-node 2 -m splendax_torch.train.train --dp 2 ...

or give the coordinator's address, the world size and the rank
explicitly.  With neither, `init_multihost` returns False: one process,
nothing to start.

Backend: NCCL when every rank on this host has a CUDA device of its own,
gloo otherwise (the CPU, or several ranks sharing one card; NCCL refuses
two ranks on one device).  Each rank takes `cuda:(local_rank % devices)`.
`spawn` starts a world of ranks on this host, as the dry run, the scaling
bench, the smoke run and the tests do.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_lib
import socket
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def choose_backend(device, local_world: int) -> str:
    """"nccl" when `device` is a card and each of the `local_world` ranks on
    this host has one of its own, else "gloo"."""
    dev = torch.device(device)
    if (dev.type == "cuda" and torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_world):
        return "nccl"
    return "gloo"


def local_world(world: int, local_world_size: int | None = None) -> int:
    """The number of ranks on this host: `local_world_size`, else torchrun's
    `LOCAL_WORLD_SIZE`, else (ranks started from explicit arguments, one per
    card as across hosts) at most one rank per card of this host."""
    if local_world_size is not None:
        return int(local_world_size)
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return min(world, cards) if cards else world


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device="cuda",
                   local_world_size: int | None = None) -> bool:
    """Start the process group iff this process is one rank of several.

    Detection: explicit arguments (`coordinator_address` "host:port",
    `num_processes`, `process_id`), or torchrun's environment.  Returns True
    if a process group is up (also when it already was: the call is
    idempotent, so `train` may run after a launcher started the group).
    `device` is where the ranks compute: "cpu" always gives gloo.
    `local_world_size` is the number of ranks on this host (`local_world`)."""
    if dist.is_initialized():
        return True
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: a coordinator address needs num_processes "
                             "and process_id")
        init_method = f"tcp://{coordinator_address}"
        world, me = int(num_processes), int(process_id)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        init_method = "env://"
        world, me = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    backend = choose_backend(device, local_world(world, local_world_size))
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", me)) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=me)
    print(f"[multihost] rank {me} of {world}, backend {backend}", flush=True)
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device: `device` itself on the CPU, else the card
    `local_rank % device_count` (raises without one, as every entry point)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def global_mesh(dp: int | None = None, tp: int = 1):
    """A dp x tp mesh over every rank; dp defaults to world size / tp."""
    from .mesh import make_mesh

    return make_mesh(dp=world_size() // tp if dp is None else dp, tp=tp)


def is_coordinator() -> bool:
    """True on the process that writes checkpoints, logs and plots."""
    return rank() == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bootstrap(fn, rank_: int, world: int, port: int, device: str, args, results) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # `world` ranks share the host's cores
        init_multihost(f"localhost:{port}", world, rank_, device=device, local_world_size=world)
        try:
            results.put((rank_, "ok", fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        results.put((rank_, "error", traceback.format_exc()))


def spawn(fn, world: int, args=(), device="cuda", timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `world` fresh ranks of one process group on this
    host (gloo unless each rank has a card of its own) and return their
    results in rank order; the ranks compute on the card unless `device` is
    "cpu".  `fn` must be importable by name: the ranks are
    started with the `spawn` method.  Raises with each failed rank's
    traceback, or when a rank gives no result within `timeout` seconds;
    every rank is stopped before returning."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_bootstrap, args=(fn, r, world, port, str(device), args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world and time.monotonic() < deadline:
            try:
                r, status, value = results.get(timeout=1.0)
            except queue_lib.Empty:
                # A rank that died without a word (a crash) ends the wait.
                if any(p.exitcode not in (None, 0) for i, p in enumerate(procs) if i not in got):
                    break
                continue
            got[r] = (status, value)
            if status == "error":
                break
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}:\n{v}" for r, (s, v) in sorted(got.items()) if s == "error"]
    if errors:
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    if len(got) < world:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"only ranks {sorted(got)} of {world} returned within {timeout} s "
                           f"(exit codes {codes})")
    return [got[r][1] for r in range(world)]
