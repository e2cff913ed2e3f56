"""Multi-process runtime: one process per rank, one card per rank.

Counterpart of ``dasa_tpu/parallel/distributed.py``, which starts JAX's
process runtime (the reference's launcher discovery, tasks/R2R/
distributed.py:7-93).  The port runs ``torch.distributed`` instead.
:func:`initialize` reads the launcher's variables: the JAX package's
``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID`` with their
OMPI and SLURM spellings, and torchrun's ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``.  With none of them set
the run is a one-rank job with no process group, as JAX's single host is.

The backend is NCCL on a machine with cards, a card a rank (more ranks
on the host than cards raises), and gloo on the CPU or when the caller
asks for it (two ranks sharing a card: NCCL refuses them).  The choice is
printed; a failed start raises and is never retried on another
backend.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

WORLD_VARS = ("NUM_PROCESSES", "JAX_NUM_PROCESSES", "OMPI_COMM_WORLD_SIZE",
              "SLURM_NTASKS", "WORLD_SIZE")
RANK_VARS = ("PROCESS_ID", "JAX_PROCESS_ID", "OMPI_COMM_WORLD_RANK",
             "SLURM_PROCID", "RANK")
LOCAL_RANK_VARS = ("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                   "SLURM_LOCALID")
LOCAL_SIZE_VARS = ("LOCAL_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE",
                   "SLURM_NTASKS_PER_NODE")


def _env_int(*names: str) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return None


def coordinator_from_env() -> Optional[str]:
    """``host:port`` of rank 0: ``COORDINATOR_ADDRESS``, else torchrun's
    ``MASTER_ADDR`` and ``MASTER_PORT``."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    return addr


def launch_config() -> Tuple[Optional[int], Optional[int], Optional[str],
                             Optional[int], Optional[int]]:
    """(world size, rank, coordinator ``host:port``, local rank, ranks on
    this host) as the launcher's variables give them, None where unset."""
    return (_env_int(*WORLD_VARS), _env_int(*RANK_VARS),
            coordinator_from_env(), _env_int(*LOCAL_RANK_VARS),
            _env_int(*LOCAL_SIZE_VARS))


def choose_backend(local_size: Optional[int],
                   backend: Optional[str] = None) -> str:
    """The caller's ``backend`` if given; else ``gloo`` on the CPU and
    ``nccl`` on a machine with cards, which takes a card a rank: it raises
    when the host's ``local_size`` ranks outnumber its cards (pass
    ``backend="gloo"`` to share one)."""
    if backend is not None:
        return backend
    if not torch.cuda.is_available():
        return "gloo"
    cards = torch.cuda.device_count()
    if local_size is not None and local_size > cards:
        raise RuntimeError(
            f"{local_size} ranks on this host but {cards} card(s): NCCL "
            "takes a card a rank; pass backend='gloo' to share one")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> Optional[str]:
    """Join the job's process group; returns its backend, or None for a
    one-rank job without launcher variables.  Idempotent.  Under NCCL the
    process takes the card of its local rank."""
    if dist.is_initialized():
        return dist.get_backend()
    env_world, env_rank, env_addr, local_rank, local_size = launch_config()
    if num_processes is None:
        num_processes = env_world
    if process_id is None:
        process_id = env_rank
    if coordinator_address is None:
        coordinator_address = env_addr
    if num_processes in (None, 1) and coordinator_address is None:
        return None  # one rank, no launcher
    num_processes = num_processes or 1
    process_id = process_id or 0
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes but no coordinator "
                         "address (COORDINATOR_ADDRESS or MASTER_ADDR)")
    backend = choose_backend(local_size, backend)
    kwargs = {}
    if backend == "nccl":
        card = torch.device("cuda", local_rank if local_rank is not None
                            else process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    print(f"torch.distributed: rank {process_id} of {num_processes}, "
          f"backend {backend}, coordinator {coordinator_address}",
          flush=True)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return backend


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Rank 0: the rank that writes checkpoints and logs (the reference's
    ``local_rank in (-1, 0)`` gates, nav_dic_pretrain.py:366-382)."""
    return rank() == 0


def barrier() -> None:
    """Every rank waits for the others (a no-op in a one-rank job)."""
    if world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()
