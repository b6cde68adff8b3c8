"""Multi-process orchestration: torch.distributed init, per-process
input splits and rank-ordered output merging; the counterpart of
finito_tpu/parallel/distributed.py.

The reference is single-process; the contract a distributed run must
keep is exact OUTPUT parity: search-fmin emits one line per read in
input order (search_fmin.hh:54-65), so a multi-process run splits the
reads into contiguous per-process slices (process 0 gets the first
slice, ...) and concatenates per-process outputs in process order --
byte-equal to the single-process run. Each process runs its own engine
(one device or a parallel.mesh mesh); the only collective is the
barrier around the merge, so the process group uses gloo, which needs
no card of its own.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join a gloo process group from the arguments or torch's standard
    variables (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK, as torchrun
    sets them); coordinator_address is "host:port". Returns
    (process_id, num_processes); (0, 1) when single-process."""
    import torch.distributed as dist

    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address and num_processes and num_processes > 1:
        dist.init_process_group(
            "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes,
            rank=process_id or 0,
        )
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


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
