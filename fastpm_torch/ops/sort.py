"""The k-sorted carry sort: K7's bitonic merge, its plain PyTorch version,
and the sort of the order-free step built on it.

Port of fastpm_tpu/ops/sort_pallas.py and of the sort of
make_prepare_carry_fn (paint_pallas.py:484-518). Under order-free
stepping the rows of a step come in the cell order of the step before,
and particles move well under a cell per step, so their new cell keys
are almost sorted: each row sits within some D ranks of its sorted
place. sort_ksorted uses that:

  1. block sort: rows of B with the odd rows descending (the key
     negated), so each adjacent pair of runs is bitonic;
  2. even merge: K7 merges the run pairs (0, 1), (2, 3), ...;
  3. odd merge: the interior second runs flipped, K7 merges the pairs
     (1, 2), (3, 4), ...; the head and tail runs pass through.

When every row is within B ranks of its place this sorts; the result
carries an exact sortedness flag, and sort_maybe_ksorted falls back to a
full sort when the flag is False, so the result is always a sort.

- K7 merge_pairs (replaces sort_pallas.py:_merge_kernel, reached through
  make_merge_pairs_fn): every wrapper dispatches on the device of the
  key: a CPU tensor takes merge_pairs_plain, a CUDA tensor launches
  csrc/bitonic_merge.cu (built at first use) or raises. It counts its
  launches in merge_pairs.launches, one per merge pass.

The block sort, the flips and the full sort are PyTorch calls, as the
JAX package leaves them to XLA. The key is int32, the payloads float32
of the same length. In the plain version every payload rides every
compare-exchange, as in the TPU kernel; the CUDA kernel runs the same
network on the key and each row's offset in its run and gathers the
payloads once (merge_offsets_plain is that form in plain PyTorch).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cic
from .cudalib import launch

__all__ = ["MAX_PAYLOADS", "merge_pairs", "merge_pairs_plain",
           "merge_offsets_plain", "block_sort", "sort_ksorted", "sort_maybe_ksorted", "carry_sort"]

# the payloads K7 takes by value in one launch
MAX_PAYLOADS = 8
_INT32_MAX = np.iinfo(np.int32).max


def _check_merge(key, payloads, B):
    """make_merge_pairs_fn's checks (sort_pallas.py:164-167) and the
    columns' types, lengths and device."""
    if B & (B - 1) or B < 128:
        raise ValueError("B must be a power of two >= 128")
    if key.ndim != 1 or key.dtype != torch.int32:
        raise ValueError("the key must be a 1-D int32 tensor")
    if key.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {key.device}")
    n = key.shape[0]
    if n % (2 * B):
        raise ValueError("n must be a multiple of 2B")
    if len(payloads) > MAX_PAYLOADS:
        raise ValueError(f"at most {MAX_PAYLOADS} payloads")
    for p in payloads:
        if (p.dtype != torch.float32 or tuple(p.shape) != (n,)
                or p.device != key.device):
            raise ValueError("payloads must be float32 tensors of the key's "
                             "length on its device")


def _network(cols, B):
    """The bitonic network of merge_pairs over the columns (cols[0] the
    key), one stride at a time over a (n / 2s, 2, s) view, as
    _butterfly_rows does it: new tensors."""
    n = cols[0].shape[0]
    s = B
    while s >= 1:
        a, b = cols[0].reshape(n // (2 * s), 2, s).unbind(1)
        swap = b < a
        out = []
        for c in cols:
            u, w = c.reshape(n // (2 * s), 2, s).unbind(1)
            out.append(torch.stack([torch.where(swap, w, u),
                                    torch.where(swap, u, w)], 1).view(n))
        cols = out
        s //= 2
    return tuple(cols)


def merge_pairs_plain(key: torch.Tensor, *payloads: torch.Tensor, B: int):
    """Plain K7: the bitonic network of merge_pairs with every payload
    riding every compare-exchange; returns (key, *payloads), new
    tensors."""
    _check_merge(key, payloads, B)
    return _network([key] + list(payloads), B)


def merge_offsets_plain(key: torch.Tensor, B: int):
    """The network of merge_pairs run on the key and each row's offset in
    its 2B-run (int32), the form K7's kernel runs: returns (key, offset).
    The swaps depend on the keys alone, so the offsets undergo the
    permutation the payloads would: payload p of merge_pairs is
    p.view(-1, 2B).gather(1, offset.view(-1, 2B)). Nothing on the main
    path calls it."""
    _check_merge(key, (), B)
    off = torch.arange(key.shape[0], dtype=torch.int32,
                       device=key.device) % (2 * B)
    return _network([key, off], B)


def merge_pairs(key: torch.Tensor, *payloads: torch.Tensor, B: int):
    """Merge every aligned pair of B-runs of (key, *payloads) where the
    first run ascends and the second descends, so that every 2B-run
    ascends (make_merge_pairs_fn). key is int32 (n,), the payloads (at
    most MAX_PAYLOADS; every JAX caller passes at most 6) float32 (n,);
    B is a power of two >= 128 and n a multiple of 2B. Ties do not swap,
    so the result is bit-identical to the TPU kernel's. Returns (key,
    *payloads), new tensors. On CUDA this launches K7
    (csrc/bitonic_merge.cu), whose launches use the new tensors as the
    scratch of its (key, offset) network."""
    _check_merge(key, payloads, B)
    if key.device.type == "cpu":
        return merge_pairs_plain(key, *payloads, B=B)
    cols = [c.contiguous() for c in (key,) + payloads]
    outs = [torch.empty_like(c) for c in cols]
    ptrs_in = (ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols))
    ptrs_out = (ctypes.c_void_p * len(outs))(*(c.data_ptr() for c in outs))
    launch("fastpm_bitonic_merge", ctypes.addressof(ptrs_in),
           ctypes.addressof(ptrs_out), len(payloads), key.shape[0], B,
           device=key.device)
    merge_pairs.launches += 1
    return tuple(outs)


merge_pairs.launches = 0


def _flip_second_runs(cols, B):
    """Reverse every odd B-run, so adjacent (even, odd) runs are bitonic
    (sort_pallas.py:200-209)."""
    n = cols[0].shape[0]
    out = []
    for c in cols:
        r = c.view(n // (2 * B), 2, B)
        out.append(torch.cat([r[:, :1], r[:, 1:].flip(-1)], 1).view(n))
    return out


def block_sort(operands, B: int):
    """Step 1 of sort_ksorted: (key, *payloads) sorted by key in rows of
    B, the odd rows descending (by key negation), so that every aligned
    pair of rows is bitonic: the input of the even merge pass."""
    key = operands[0]
    n = key.shape[0]
    if n % (2 * B):
        raise ValueError("n must be a multiple of 2B")
    nb = n // B
    sign = 1 - 2 * (torch.arange(nb, dtype=torch.int32,
                                 device=key.device) & 1)[:, None]
    kb, order = torch.sort(key.reshape(nb, B) * sign, dim=1)
    return [(kb * sign).view(n)] + [
        p.reshape(nb, B).gather(1, order).view(n) for p in operands[1:]]


def sort_ksorted(operands, B: int):
    """Sort (key, *payloads) by key, for rows that each sit within about B
    ranks of their sorted place (sort_pallas.py:212-251). Returns
    (sorted operands, ok): ok is a bool tensor on the device, the exact
    sortedness of the result; when it is False the caller must sort in
    full (sort_maybe_ksorted does)."""
    n = operands[0].shape[0]
    # 1. block sort, 2. even merge
    even = merge_pairs(*block_sort(operands, B), B=B)
    # 3. odd merge of the interior runs; the head and tail runs pass
    if n >= 4 * B:
        mid = _flip_second_runs([c[B:n - B] for c in even], B)
        mid = merge_pairs(*mid, B=B)
        even = tuple(torch.cat([e[:B], m, e[n - B:]])
                     for e, m in zip(even, mid))
    ok = (even[0][1:] >= even[0][:-1]).all()
    return even, ok


def sort_maybe_ksorted(operands, B: int):
    """Sort (key, *payloads) by key: the k-sorted fast path, or, when its
    flag says the result is not sorted, a full sort of the operands
    (sort_pallas.py:254-266). The flag is one fetch to the host per
    call; sort_maybe_ksorted.fallbacks counts the full sorts."""
    fast, ok = sort_ksorted(operands, B)
    if bool(ok):
        return fast
    sort_maybe_ksorted.fallbacks += 1
    key, order = torch.sort(operands[0], stable=True)
    return (key,) + tuple(p[order] for p in operands[1:])


sort_maybe_ksorted.fallbacks = 0


def carry_sort(x: torch.Tensor, v: torch.Tensor, nmesh, inv_cell,
               sort_block: int | None = None, donate: bool = False):
    """The sort of the order-free step (make_prepare_carry_fn,
    paint_pallas.py:484-518): (x, v) sorted by the int32 cell key of x.
    With sort_block the k-sorted sort of (key, x0..2, v0..2) with runs of
    sort_block, padded to a multiple of 2 * sort_block with INT32_MAX keys
    (which sort last and are sliced off); else a full sort and two
    gathers. Rows of one cell come in an order the two do not share.
    donate: the caller gives x and v up (the JAX step's donation): the
    sorted rows are written into them, one column at a time, and they
    are returned. carry_sort.calls counts the calls."""
    carry_sort.calls += 1
    if sort_block is None:
        order = cic.sort_by_cell(x, nmesh, inv_cell)
        if not donate:
            return x[order], v[order]
        # one sorted column alive at a time
        x.copy_(x[order])
        v.copy_(v[order])
        return x, v
    key = cic.cell_key(x, nmesh, inv_cell)
    n = x.shape[0]
    npad = -(-n // (2 * sort_block)) * (2 * sort_block)
    cols = [key] + list(x.unbind(1)) + list(v.unbind(1))
    if npad != n:
        cols = [torch.cat([c, c.new_full((npad - n,), _INT32_MAX if i == 0
                                         else 0)])
                for i, c in enumerate(cols)]
    out = sort_maybe_ksorted(cols, sort_block)
    del cols
    if donate:
        x.copy_(torch.stack(out[1:4], 1)[:n])
        v.copy_(torch.stack(out[4:7], 1)[:n])
        return x, v
    return (torch.stack(out[1:4], 1)[:n].contiguous(),
            torch.stack(out[4:7], 1)[:n].contiguous())


carry_sort.calls = 0
