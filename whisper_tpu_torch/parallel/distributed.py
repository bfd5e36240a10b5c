"""Multi-process initialization and batch sharding helpers.

Counterpart of the JAX package's parallel/distributed.py. The reference's
only networked path is the ggml-rpc tensor server; the JAX package runs
jax.distributed, one process per host. The port runs one process per
rank over `torch.distributed`: each rank drives one card (NCCL), or
several ranks share one card or run on the CPU (gloo).

A serving run, one process per card; each rank's card receives only its
shard of the weights:

    import whisper_tpu_torch as pt
    from whisper_tpu_torch.parallel import distributed
    distributed.init_distributed("tcp://host0:29500", n_procs, rank)
    ctx = pt.WhisperContext.new_with_params(
        path, pt.ContextParams(mesh_shape=(n_procs // TP, TP)))
    results = ctx.full_batch(p, audios)     # every rank passes all audios
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> dict:
    """Initialize the default process group of a multi-process run.

    `coordinator_address` is an init_method URL (`tcp://host:port`, or
    `file:///path` for ranks on one machine). The backend is NCCL when
    each rank has a card of its own: the card `process_id % device_count`
    becomes this process's current device. It is gloo on the CPU. The
    caller names "gloo" for ranks that share one card: NCCL refuses two
    ranks on one device, and gloo reduces CUDA tensors through the host.
    The choice is the caller's, never a switch made after a failure.
    Without arguments the call only reports (an initialized group, or a
    single process). Returns process_index, process_count and the device
    counts."""
    if not dist.is_initialized() and (coordinator_address or num_processes
                                      or process_id is not None):
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=coordinator_address,
                                world_size=num_processes, rank=process_id)
    return {
        "process_index": process_index(),
        "process_count": host_count(),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "local_devices": torch.cuda.device_count(),
    }


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_count() -> int:
    """Processes in the run (the JAX package's jax.process_count())."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int, n_parts: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """This part's slice of a batch of `global_batch` utterances split over
    `n_parts` (default: the processes; `index` default: this process).
    The remainder goes one each to the first `global_batch % n_parts`
    parts, so every utterance is assigned exactly once."""
    p = max(1, host_count() if n_parts is None else n_parts)
    i = process_index() if index is None else index
    per, rem = divmod(global_batch, p)
    start = i * per + min(i, rem)
    return slice(start, start + per + (1 if i < rem else 0))
