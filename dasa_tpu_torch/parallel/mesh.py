"""The data axis of a data-parallel job.

Counterpart of ``dasa_tpu/parallel/mesh.py``.  JAX runs one process over a
``('data', 'model')`` device mesh and GSPMD inserts the collectives; the
port runs one process per rank (``parallel/distributed.py``), and rank r
plays JAX's device r: it takes the r-th block of every batch axis that the
ranks divide, and computes the same global objective from its rows, with
the sums that normalise or report the loss reduced over the ranks and the
gradients summed by one flat all-reduce.  Where the ranks do not divide a
batch axis, every rank takes all of it, as GSPMD replicates such an array,
and the math stays the single-device math.  ``n_model`` stays 1, as in
the JAX package.

Collectives run whenever a process group exists (a one-rank job included,
so that its backend is exercised); under gloo a CUDA tensor travels
through host memory.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from dasa_tpu_torch.parallel import distributed


class DataMesh:
    """``n_data`` ranks on the data axis, this process being ``rank``."""

    n_model = 1

    def __init__(self, n_data: int, rank: int):
        self.n_data = n_data
        self.rank = rank
        self._grouped = dist.is_initialized()
        self._gloo = self._grouped and dist.get_backend() == "gloo"

    def divides(self, n: int) -> bool:
        return n % self.n_data == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch axis of ``n``: its block when the
        ranks divide ``n``, else every row (replicated)."""
        if not self.divides(n):
            return slice(0, n)
        size = n // self.n_data
        return slice(self.rank * size, (self.rank + 1) * size)

    def shard_batch(self, tree, axis: int = 0):
        """This rank's slice of each leaf's ``axis`` (tensors and numpy
        arrays, in dicts, lists and tuples); leaves whose axis the ranks do
        not divide, and leaves without the axis, stay whole."""
        if isinstance(tree, dict):
            return {k: self.shard_batch(v, axis) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.shard_batch(v, axis) for v in tree)
        if not isinstance(tree, (torch.Tensor, np.ndarray)) or \
                tree.ndim <= axis:
            return tree
        index = [slice(None)] * tree.ndim
        index[axis] = self.rows(tree.shape[axis])
        return tree[tuple(index)]

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------
    def _run(self, fn, t: torch.Tensor) -> torch.Tensor:
        """``fn`` (an in-place collective) on ``t``; under gloo a CUDA
        tensor goes through host memory."""
        if self._gloo and t.is_cuda:
            host = t.cpu()
            fn(host)
            t.copy_(host)
        else:
            fn(t)
        return t

    def replicate_module(self, module: torch.nn.Module) -> None:
        """Broadcast the module's parameters and buffers from rank 0, in
        place."""
        if not self._grouped:
            return
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                self._run(lambda x: dist.broadcast(x, 0), t)

    def allsum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, as a new tensor outside the
        autograd graph (a denominator or a logged sum)."""
        if not self._grouped:
            return x
        return self._run(dist.all_reduce, x.detach().clone())

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
        rank order."""
        if not self._grouped:
            return x
        x = x.detach().contiguous()
        if self._gloo and x.is_cuda:
            parts = [torch.empty_like(x, device="cpu")
                     for _ in range(self.n_data)]
            dist.all_gather(parts, x.cpu())
            return torch.cat(parts, dim).to(x.device)
        parts = [torch.empty_like(x) for _ in range(self.n_data)]
        dist.all_gather(parts, x)
        return torch.cat(parts, dim)

    def barrier(self) -> None:
        if self._grouped:
            dist.barrier()

    def gather_objects(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if not self._grouped:
            return [obj]
        out: List[Optional[object]] = [None] * self.n_data
        dist.all_gather_object(out, obj)
        return out

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Sum the parameters' gradients over the ranks with ONE flat f32
        all-reduce; a missing gradient counts as zero (and becomes one),
        as the optimizer steps it (``train/optim.py:fill_missing_grads_``)."""
        if not self._grouped:
            return
        params = [p for p in params if p.requires_grad]
        if not params:
            return
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in params])
        self._run(dist.all_reduce, flat)
        offset = 0
        for p in params:
            n = p.numel()
            part = flat[offset:offset + n].view_as(p)
            if p.grad is None:
                p.grad = part.to(p.dtype).clone()
            else:
                p.grad.copy_(part)
            offset += n


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DataMesh:
    """The data axis over the job's ranks (``distributed.initialize`` first
    for more than one).  ``n_data`` defaults to the world size and must
    equal it: a rank holds one card and one data shard."""
    world = distributed.world_size()
    if n_model != 1:
        raise ValueError("n_model must be 1: the port has no model axis")
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data {n_data} != the job's {world} ranks: "
                         "launch one process a data shard")
    return DataMesh(world, distributed.rank())


def rank_seed(seed: int, mesh: Optional[DataMesh]) -> int:
    """A seed of this rank's own random stream (the JAX window folds the
    device index into its key, ``dasa_tpu/agents/stream.py:275-281``);
    ``seed`` itself without a mesh or at rank 0 of one rank."""
    if mesh is None or mesh.n_data == 1:
        return seed
    return (seed * 1_000_033 + 7919 * (mesh.rank + 1)) % 2 ** 62
