"""The collectives of the slab force over a ring of torch.distributed
ranks.

The JAX package writes its multi-device force inside shard_map, where
the collectives come from jax.lax (axis_index, ppermute, psum,
all_to_all, psum_scatter, all_gather); this module is their counterpart
over a process group (NCCL on the card, gloo on the CPU) and has no file
of its own in the JAX package. Each rank calls every collective in the
same order with tensors of the same shape.

A block whose peer is the rank itself is a local copy: on one rank every
hop of the halo exchange wraps to the rank itself, the periodic fold of
psolver.py:_halo_reduce for nproc == 1, and the same holds for a hop of
a multiple of nproc. A Ring without a process group is one rank and
runs no collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["Ring"]


class Ring:
    """The ranks of a process group as a ring: rank r's neighbour at hop
    m is rank (r + m) % nproc."""

    def __init__(self, group=None):
        """group: a torch.distributed process group (dist.group.WORLD
        for every process), or None for one rank alone."""
        self.group = group
        if group is None:
            self.rank, self.nproc = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.nproc = dist.get_world_size(group)
        # where a number travels: NCCL reduces only CUDA tensors
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if group is not None
                       and dist.get_backend(group) == "nccl"
                       else torch.device("cpu"))

    def axis_index(self) -> int:
        """This rank's position on the ring (jax.lax.axis_index)."""
        return self.rank

    def _peer(self, r: int) -> int:
        """The global rank of ring position r."""
        return dist.get_global_rank(self.group, r % self.nproc)

    def ppermute(self, t: torch.Tensor, hop: int) -> torch.Tensor:
        """Send t to the rank hop places on (hop < 0: back) and return the
        block received from the rank hop places back: out on rank r is t
        of rank r - hop (jax.lax.ppermute with the shift permutation)."""
        t = t.contiguous()
        if hop % self.nproc == 0:
            return t.clone()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, self._peer(self.rank + hop),
                          self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank - hop),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def psum(self, t):
        """The sum over ranks of a tensor (a new tensor) or a number."""
        if not torch.is_tensor(t):
            if self.nproc == 1:
                return t
            return self.psum(torch.tensor(t, dtype=torch.float64,
                                          device=self.device)).item()
        t = t.clone()
        if self.nproc > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum over ranks (a new tensor)."""
        t = t.clone()
        if self.nproc > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_to_all(self, t: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all_to_all: cut t in nproc blocks along split_dim, send
        block j to rank j, and concatenate the blocks received along
        concat_dim in rank order (jax.lax.all_to_all, tiled=True).
        Complex tensors travel as their real views."""
        if self.nproc == 1:
            return t
        cplx = t.is_complex()
        if cplx:
            t = torch.view_as_real(t)
        send = torch.stack(t.chunk(self.nproc, dim=split_dim)).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        out = torch.cat(recv.unbind(0), dim=concat_dim)
        return torch.view_as_complex(out) if cplx else out

    def psum_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum t over ranks and keep this rank's block of nproc along dim
        0 (jax.lax.psum_scatter, scatter_dimension=0, tiled=True)."""
        if self.nproc == 1:
            return t.clone()
        t = t.contiguous()
        out = torch.empty((t.shape[0] // self.nproc,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along dim 0 in rank order
        (jax.lax.all_gather, axis=0, tiled=True)."""
        if self.nproc == 1:
            return t.clone()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.nproc)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def gather_rows(self, t: torch.Tensor):
        """Every rank's rows of t (any length along dim 0) concatenated in
        rank order on rank 0, None elsewhere."""
        if self.nproc == 1:
            return t
        t = t.contiguous()
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        counts = [int(c) for c in self.all_gather(n)]
        if self.rank != 0:
            dist.send(t, self._peer(0), group=self.group)
            return None
        parts = [t]
        for r in range(1, self.nproc):
            part = torch.empty((counts[r],) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
            dist.recv(part, self._peer(r), group=self.group)
            parts.append(part)
        return torch.cat(parts)
