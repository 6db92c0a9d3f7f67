"""Start one process a rank and join them (torch.multiprocessing, the
`spawn` start method: CUDA cannot be initialised in a forked child).

    spawn(fn, world, device_type, backend, args)

runs fn(comm, *args) in `world` new processes, rank r on card r (or on
the CPU), each joined to a process group over TCP at 127.0.0.1 on a
free port.  The kernels (and the host BVH builder) are built once here,
before the ranks start, so the ranks do not run the compilers N times.
If a rank raises or dies, the others are terminated and spawn raises.
A rank that waits in a collective longer than `timeout` seconds raises,
so a lost peer ends the job instead of hanging it.

Two ranks cannot share a card on NCCL; on gloo they can (`devices`
maps ranks to cards, rank r on card r % the visible cards by default).
"""

from __future__ import annotations

import socket

import torch
import torch.multiprocessing as mp

from .comm import BACKENDS, Comm

ADDR = "127.0.0.1"


def free_port(addr: str = ADDR) -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((addr, 0))
        return s.getsockname()[1]


def rank_devices(world: int, device_type: str, backend: str) -> list:
    """Each rank's device: cuda:r % cards, or cpu.  NCCL needs a card of
    its own for every rank (ValueError otherwise)."""
    if device_type == "cpu":
        return ["cpu"] * world
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}")
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available")
    if backend == "nccl" and world > cards:
        raise ValueError(f"NCCL takes one card a rank: {world} ranks, "
                         f"{cards} cards (two ranks can share a card over "
                         f"gloo)")
    return [f"cuda:{r % cards}" for r in range(world)]


def build_libraries(device_type: str):
    """Build the native libraries the ranks load (the host BVH builder,
    and the CUDA kernels for ranks on cards)."""
    from .. import libbuild
    from ..accel import native

    libs = [native.LIB]
    if device_type == "cuda":
        from ..ops import (dispatch, khit, merge, pairs, shade,
                           stream_traverse, vcm_shade)
        from ..render import graphs

        libs += [stream_traverse.LIB, khit.LIB, merge.LIB, pairs.LIB,
                 shade.LIB, vcm_shade.LIB, dispatch.LIB, graphs.COND_LIB]
    libbuild.build_all(libs)


def _rank_main(rank, fn, world, devices, backend, port, timeout, threads,
               args):
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if threads:
        torch.set_num_threads(threads)
    comm = Comm.init(backend, ADDR, port, rank, world, dev, timeout=timeout)
    try:
        fn(comm, *args)
    finally:
        comm.close()


def spawn(fn, world: int, device_type: str = "cuda", backend: str = None,
          args: tuple = (), timeout: float = 600.0, threads: int = 0):
    """Run fn(comm, *args) on `world` ranks and wait for all of them.
    `backend` defaults to nccl on cards and gloo on the CPU; `threads`,
    when non-zero, caps each rank's torch threads.  `fn` must be a
    module-level function (the ranks import it)."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unsupported backend {backend!r}")
    devices = rank_devices(world, device_type, backend)
    build_libraries(device_type)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, devices, backend, free_port(), timeout,
                          threads, args),
        nprocs=world, join=False, start_method="spawn")
    try:
        # join() raises when a rank failed, after terminating the others.
        while not ctx.join():
            pass
    except BaseException:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        raise
