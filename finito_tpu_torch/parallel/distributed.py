"""Multi-process orchestration over torch.distributed; the counterpart
of finito_tpu/parallel/distributed.py.

Two uses of a process group:

  * the read split: the reference is single-process, and a multi-process
    run must keep its exact OUTPUT: search-fmin emits one line per read
    in input order (search_fmin.hh:54-65), so each process runs its own
    engine (one device or a one-process parallel.mesh mesh) on a
    contiguous slice of the reads (process 0 gets the first slice, ...),
    and the per-process parts concatenate in process order, byte-equal
    to the single-process run; the barrier around the merge is the only
    collective;
  * a mesh that spans processes: global_devices gathers every rank's
    own devices into one Devices list in rank order (JAX's jax.devices()
    order: process 0's devices first), each entry tagged with the rank
    that holds it. A parallel.mesh.Mesh or a mesh build over that list
    keeps on each process only the shards its own devices hold, and
    every collective of the mesh layer crosses processes
    (parallel.shard_build's collectives layer).

The backend is the caller's: gloo moves host tensors (a CUDA tensor is
staged through the host, explicitly and counted), nccl moves CUDA
tensors card to card and needs one card a rank; nothing switches one
for the other.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch

BACKENDS = ("gloo", "nccl")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "gloo",
    timeout: Optional[float] = None,
) -> Tuple[int, int]:
    """Join a process group from the arguments or torch's standard
    variables (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK, as torchrun
    sets them); coordinator_address is "host:port". backend: "gloo" or
    "nccl", as given. timeout: seconds a collective may wait before it
    fails (torch's default when None), so that ranks that diverge fail
    fast. Returns (process_id, num_processes); (0, 1) when
    single-process, and then no group is made."""
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address and num_processes and num_processes > 1:
        kwargs = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id or 0,
            **kwargs,
        )
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_count() -> int:
    """jax.process_count(): the number of processes, 1 without a group."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """jax.process_index(): this process's rank, 0 without a group."""
    import torch.distributed as dist

    return dist.get_rank() if process_count() > 1 else 0


class Devices(list):
    """A mesh's devices in shard order (a list of torch.device), each
    tagged with the rank of the process that holds it (owners). A
    process keeps and computes only its own shards (local); the others
    are other processes' devices, which this one never touches, even
    where the names are equal (two ranks on one card both hold
    "cuda:0"). One process: every owner is 0. backend is the group's
    where the list spans processes, else None; stats counts the
    collectives that crossed processes and the bytes staged between a
    card and the host for them."""

    def __init__(self, devices, owners=None, rank: int = 0, backend: Optional[str] = None):
        super().__init__(torch.device(d) for d in devices)
        self.owners = [rank] * len(self) if owners is None else [int(o) for o in owners]
        if len(self.owners) != len(self):
            raise ValueError(f"{len(self)} devices but {len(self.owners)} owners")
        self.rank = rank
        self.backend = backend if self.spans else None
        self.stats = {"collectives": 0, "staged_bytes": 0}

    @property
    def local(self) -> List[int]:
        """The shards this process holds, in shard order."""
        return [s for s, o in enumerate(self.owners) if o == self.rank]

    @property
    def spans(self) -> bool:
        """True when other processes hold some of the shards."""
        return any(o != self.rank for o in self.owners)

    @property
    def stage(self) -> torch.device:
        """Where a collective's tensors sit: the host under gloo, this
        rank's first device under nccl."""
        return torch.device("cpu") if self.backend != "nccl" else self[self.local[0]]


def _physical(d: torch.device) -> str:
    """The card behind a device (its UUID), or "cpu"."""
    if d.type == "cuda":
        return f"cuda {torch.cuda.get_device_properties(d).uuid}"
    return d.type


def check_backend(backend: str, entries: Sequence[Sequence[Tuple[str, str]]]) -> None:
    """entries[r]: rank r's devices as (name, physical id). nccl moves
    CUDA tensors between cards, one card a rank: a CPU device, or one
    card held by two ranks, raises (nothing falls back to gloo)."""
    if backend != "nccl":
        return
    held = {}
    for r, devs in enumerate(entries):
        for name, phys in devs:
            if not phys.startswith("cuda"):
                raise ValueError(f"backend nccl moves CUDA tensors only; rank {r} holds {name} "
                                 "(use backend='gloo')")
            if held.setdefault(phys, r) != r:
                raise ValueError(f"backend nccl needs one card a rank; ranks {held[phys]} and {r} "
                                 f"both hold {name} ({phys}) (use backend='gloo', or a card a rank)")


def global_devices(local_devices: Sequence) -> Devices:
    """Every rank's own devices (local_devices, this process's) gathered
    into one Devices list in rank order, process 0's first: the global
    device view a cross-process mesh is made of. Called by every rank
    together. Without a group, or with one rank, local_devices alone
    and no torch.distributed call."""
    local = [torch.device(d) for d in local_devices]
    if not local:
        raise ValueError("a rank must hold at least one device")
    if process_count() == 1:
        return Devices(local)
    import torch.distributed as dist

    backend = dist.get_backend()
    # the device lists travel by gloo: under nccl a card shared by two
    # ranks must raise here, before any nccl collective meets it
    meta = dist.new_group(backend="gloo") if backend == "nccl" else None
    entries: list = [None] * dist.get_world_size()
    dist.all_gather_object(entries, [(str(d), _physical(d)) for d in local], group=meta)
    check_backend(backend, entries)
    if backend == "nccl":
        torch.cuda.set_device(local[0])
    devs, owners = [], []
    for r, ds in enumerate(entries):
        devs += [name for name, _ in ds]
        owners += [r] * len(ds)
    return Devices(devs, owners, rank=dist.get_rank(), backend=backend)


def distributed_barrier(name: str) -> None:
    """Block until every process reaches this point (dist.barrier). No-op
    in a 1-process run. name labels the sync point for the reader."""
    import torch.distributed as dist

    del name
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return
    dist.barrier()


def process_slice(n_items: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """Contiguous [start, end) of items owned by a process. Contiguous
    (not strided) so per-process outputs concatenate in process order
    into the exact single-process ordering."""
    base, rem = divmod(n_items, num_processes)
    start = process_id * base + min(process_id, rem)
    return start, start + base + (1 if process_id < rem else 0)


def split_for_process(items: Sequence, process_id: int, num_processes: int):
    a, b = process_slice(len(items), process_id, num_processes)
    return items[a:b]


def part_path(out_path: str, process_id: int) -> str:
    return f"{out_path}.part{process_id:05d}"


def write_part(out_path: str, process_id: int, lines: Sequence[str]) -> str:
    p = part_path(out_path, process_id)
    with open(p, "w") as f:
        for line in lines:
            f.write(line if line.endswith("\n") else line + "\n")
    return p


def merge_parts(out_path: str, num_processes: int, remove: bool = True) -> None:
    """Concatenate part files in process order -> byte-equal to the
    single-process output (run on process 0 after a barrier)."""
    with open(out_path, "w") as out:
        for pid in range(num_processes):
            p = part_path(out_path, pid)
            with open(p) as f:
                out.write(f.read())
            if remove:
                os.remove(p)


def run_distributed_queries(engine, reads: List[bytes], out_path: str,
                            process_id: int, num_processes: int,
                            barrier: bool = False) -> None:
    """Per-process slice -> batched engine -> part file -> merge.

    With barrier=True (a real torch.distributed run) the merge is fully
    owned here: every process syncs after writing its part, process 0
    concatenates, and a second sync holds everyone until the merged file
    exists. barrier=False is for single-process or simulated runs where
    the caller sequences the parts itself."""
    mine = split_for_process(reads, process_id, num_processes)
    lines = []
    for f, r in engine.process_reads(mine):
        parts = []
        n = len(f.local_offsets)
        for i in range(n):
            u, p = f.local_offsets[i]
            if u == -1:
                u, p = r.local_offsets[n - 1 - i]
            parts.append(f"({u},{p})")
        lines.append(" ".join(parts))
    write_part(out_path, process_id, lines)
    if num_processes == 1:
        merge_parts(out_path, 1)
    elif barrier:
        distributed_barrier(f"finito:parts:{out_path}")
        if process_id == 0:
            merge_parts(out_path, num_processes)
        distributed_barrier(f"finito:merged:{out_path}")
