"""Multi-process initialisation and per-rank data (port of
``hands_tpu/parallel/distributed.py``).

One process per rank, launched by the user with ``--num_processes N
--process_id r --coordinator_address host:port`` as the JAX CLI is (or by
``torchrun``: an empty address reads ``MASTER_ADDR`` / ``MASTER_PORT``).
:func:`initialize_from_config` brings the ``torch.distributed`` group up
before any device use, gives every rank rank 0's experiment key, and picks
the rank's device, ``cuda:(process_id % device_count)``.

**The backend rule** (fixed, not a fallback): NCCL when every rank has a card
of its own; gloo when ranks share a card (NCCL refuses two ranks on one
device) and on the CPU. gloo carries CUDA tensors through the host; every
collective the trainer uses (all-reduce, all-gather and reduce-scatter into
tensors, the object broadcasts) takes them. A rank whose group does not come
up raises, and the run ends with a non-zero exit.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from hands_tpu_torch.parallel.mesh import DataGroup

TIMEOUT = datetime.timedelta(seconds=600)  # a collective's longest wait


def backend_for(device_type: str, num_processes: int,
                device_count: Optional[int] = None) -> str:
    """``gloo`` on the CPU or when ranks share a card, else ``nccl``."""
    if device_type != "cuda":
        return "gloo"
    if device_count is None:
        device_count = torch.cuda.device_count()
    return "nccl" if num_processes <= device_count else "gloo"


def device_for(process_id: int, device: str) -> torch.device:
    """The rank's device: the CPU, or card ``process_id % device_count``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", process_id % torch.cuda.device_count())


def init_method(coordinator_address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``file://...``,
    ``tcp://...``) is kept; empty -> ``env://`` (torchrun's variables)."""
    if not coordinator_address:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str],
               num_processes: Optional[int], process_id: Optional[int],
               device: str = "cuda") -> torch.device:
    """Bring the process group up (nothing for one process) and return this
    rank's device."""
    if not num_processes or num_processes <= 1:
        return torch.device(device)
    dev = device_for(process_id, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(dev.type, num_processes)
    dist.init_process_group(
        backend, init_method=init_method(coordinator_address or ""),
        rank=process_id, world_size=num_processes, timeout=TIMEOUT)
    print(f"multi-process: process {dist.get_rank()}/"
          f"{dist.get_world_size()}, backend {backend}, device {dev}",
          flush=True)
    return dev


def initialize_from_config(cfg, device: str = "cuda"):
    """CLI entry helper: the process group from ``--num_processes /
    --process_id / --coordinator_address``, BEFORE any device use, and rank
    0's experiment key on every rank (they share one ``logs/<key>`` tree,
    where rank 0 alone writes). Returns (cfg, this rank's device); nothing
    changes for one process."""
    if cfg.num_processes <= 1:
        return cfg, device
    dev = initialize(cfg.coordinator_address, cfg.num_processes,
                     cfg.process_id, device)
    if not cfg.exp_key and not cfg.resume_ckpt:
        from hands_tpu_torch.utils.experiment import generate_exp_key

        key = [generate_exp_key() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(key, src=0)
        cfg = cfg.replace(exp_key=key[0])
    return cfg, str(dev)


def is_multiprocess() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if is_multiprocess() else 0


def process_count() -> int:
    return dist.get_world_size() if is_multiprocess() else 1


def data_group() -> Optional[DataGroup]:
    """The default group as a :class:`DataGroup`, or ``None`` for one
    process."""
    if not is_multiprocess():
        return None
    return DataGroup(None, dist.get_rank(), dist.get_world_size())


def host_shard_range(global_batch: int) -> Tuple[int, int]:
    """[start, end) of the global batch this rank must load."""
    per_host = global_batch // process_count()
    start = process_index() * per_host
    return start, start + per_host


def gather_to_host(tree: dict) -> dict:
    """Every rank's rows of each tensor, concatenated in rank order, on every
    rank: an all-gather of the metric rows (a collective: every rank calls
    it). Non-tensor values pass through; nothing happens for one process."""
    if not is_multiprocess():
        return tree
    out = {}
    for k, v in tree.items():
        if not torch.is_tensor(v):
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, v.contiguous())
        out[k] = torch.cat(parts, dim=0)
    return out


def barrier() -> None:
    if is_multiprocess():
        dist.barrier()


def shutdown() -> None:
    """Tear the group down (each rank, at the end of its run)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
