"""Multi-process decode on torch.distributed: the process group, its
collectives and a launcher of the ranks of one host.

Counterpart of jxl_tpu's jax.distributed set-up (parallel/multihost.py:
init_distributed) and of the collectives its shard_map programs lower to
(ppermute, all-gather). A `World` is one rank's view of the process
group: its rank, size, backend and device. Its two collectives are all a
sharded decode needs: `exchange` (point-to-point sends and receives
between neighbours, the halo of parallel/sharded_render.py) and
`all_gather` (tensors of any shape from every rank, in rank order).

The backend is named by the caller, never guessed after a failure:
- "nccl" moves CUDA tensors between cards; one rank a card (NCCL refuses
  two ranks of one communicator on one GPU).
- "gloo" moves CPU tensors. A gloo world on the card (several ranks
  sharing one GPU) stages each message explicitly: the sender copies it
  into a page-locked host buffer, gloo moves it, and the receiver copies
  it up to its device. The exchange counts those bytes and seconds like
  any other; they are not the time of a transfer between cards.

`run_local_world` spawns the ranks of one host (the start method "spawn",
a FileStore or TCP address from the caller) and returns what each rank's
function returned. On a host with one card a rank takes device
cuda:{local_rank % device_count}; torchrun, one rank a card over NCCL, is
the way to run the same functions across cards.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


class World:
    """One rank of an initialised process group: rank, size, backend and
    the device its tensors live on. exchange_bytes and exchange_s count
    what exchange() moved since they were last set to 0: bytes sent by
    this rank, and host seconds from its first send to its last receive
    (with staging, the copies to and from the host included; with NCCL,
    the host's wait for the transfers to be queued)."""

    def __init__(self, backend: str, device, rank: int, size: int):
        self.backend = backend
        self.device = torch.device(device)
        self.rank = rank
        self.size = size
        self.exchange_bytes = 0
        self.exchange_s = 0.0

    @property
    def staged(self) -> bool:
        """Whether messages go through host buffers: gloo with CUDA
        tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def exchange(self, sends: list, recvs: list) -> list:
        """Point-to-point messages: `sends` [(peer, tensor)], `recvs`
        [(peer, shape, dtype)], at most one message each way a peer.
        Returns the received tensors on this rank's device, in the order
        of `recvs`. Every rank of a pair must call it with the matching
        send and receive."""
        t0 = time.perf_counter()
        ops, outs = [], []
        for peer, t in sends:
            t = t.contiguous()
            t = self._host(t) if self.staged else t
            ops.append(dist.P2POp(dist.isend, t, peer))
            self.exchange_bytes += t.numel() * t.element_size()
        for peer, shape, dtype in recvs:
            out = self._empty(shape, dtype)
            outs.append(out)
            ops.append(dist.P2POp(dist.irecv, out, peer))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if self.staged:
            outs = [o.to(self.device, non_blocking=True) for o in outs]
        self.exchange_s += time.perf_counter() - t0
        return outs

    def all_gather(self, t: torch.Tensor) -> list:
        """`t` of every rank, in rank order, on this rank's device: each
        rank's tensor may have its own shape (same dtype and number of
        dimensions)."""
        shapes = [s.tolist() for s in self._gather(torch.tensor(t.shape, dtype=torch.int64))]
        n = max(int(np.prod(s)) for s in shapes)
        flat = torch.zeros(n, dtype=t.dtype, device=self.device)
        flat[: t.numel()] = t.reshape(-1)
        return [p[: int(np.prod(s))].reshape(s) for p, s in zip(self._gather(flat), shapes)]

    def _gather(self, t: torch.Tensor) -> list:
        """dist.all_gather of same-shape tensors, on this rank's device."""
        t = self._host(t) if self.staged else t.to(self.device)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return [p.to(self.device, non_blocking=True) for p in parts]


def init_distributed(init_method: str, world_size: int, rank: int, backend: str | None = None,
                     device="cuda", local_rank: int | None = None) -> World:
    """Join the process group and return this rank's World. init_method:
    "file:///path" (a FileStore) or "tcp://host:port". device: "cuda" puts
    the rank on cuda:{local_rank % device_count} (local_rank defaults to
    rank), "cpu" on the host; without a card "cuda" raises. backend:
    "nccl" (the default on the card) or "gloo" (the default on the CPU,
    and the way to run several ranks on one card). A group that fails to
    come up raises."""
    dev_type = torch.device(device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available; pass "
                               "device='cpu' with the gloo backend")
        local = rank if local_rank is None else local_rank
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the nccl backend moves CUDA tensors; use gloo on the CPU")
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return World(backend, dev, rank, world_size)


def _rank_main(rank, world_size, init_method, backend, device, threads, inbox, queue):
    """One spawned rank: take the pickled (fn, args) from `inbox`, join,
    run fn(world, *args), report on `queue`, leave. (The work comes
    through a queue, not the process's arguments: a start whose arguments
    fill the pipe waits for the child to import its parent's main module,
    and the ranks would start one after another.)"""
    try:
        if threads:
            torch.set_num_threads(threads)
        fn, args = pickle.loads(inbox.get())
        world = init_distributed(init_method, world_size, rank, backend, device)
        try:
            queue.put((rank, True, fn(world, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))


def run_local_world(fn, world_size: int, init_file: str, args=(), backend: str | None = None,
                    device="cuda", threads: int = 0, timeout: float = 600.0) -> list:
    """Spawn `world_size` ranks on this host, each running fn(world,
    *args) (fn a module-level function, args picklable), the group met
    through a FileStore at `init_file` (a path that does not exist yet).
    threads: torch's intra-op threads a rank (0 keeps torch's default).
    Returns each rank's result, in rank order; raises RuntimeError with a
    rank's traceback if any rank fails, or after `timeout` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue, inbox = ctx.Queue(), ctx.Queue()
    init_method = "file://" + os.path.abspath(init_file)
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, init_method, backend, device,
                                                  threads, inbox, queue), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    payload = pickle.dumps((fn, tuple(args)))
    for _ in procs:
        inbox.put(payload)
    results, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                if errors:
                    break
                raise RuntimeError(f"run_local_world: ranks did not finish in {timeout} s")
            try:
                rank, ok, value = queue.get(timeout=min(left, 5.0))
            except queue_mod.Empty:  # look for a rank that died without a report
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"run_local_world: rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}") from None
                continue
            if ok:
                results[rank] = value
            else:
                # the other ranks may wait in a collective for this one
                errors.append(f"rank {rank}:\n{value}")
                deadline = min(deadline, time.monotonic() + 30.0)
        if errors:
            raise RuntimeError("run_local_world: " + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world_size)]
