"""Inputs of K7's merge (ops/sort.py:merge_pairs), made from a numpy seed:
runs of B with the even runs ascending and the odd runs descending, and
payloads that move with their keys. The key kinds pin what the network
must get right: unique keys (every compare decides), all keys equal (no
pair may swap) and 4 distinct values (ties everywhere, so the payload
order on ties shows).

Used by tests/test_torch_sort.py (the CPU and cuda cases) and
chip_smoke.py (the kernel against its plain version on the card).
"""

import numpy as np

KINDS = ("unique", "equal", "four")
# the sizes the kernel's launches depend on: a tile of 8192 (key, offset)
# pairs, so B below, at half, at and above the tile, the carry sort's
# 32768 and 2B past the 16-bit offsets
BLOCKS = (128, 1024, 4096, 8192, 32768, 65536)
PAYLOADS = (0, 1, 6, 8)


def bitonic_case(kind, n, B, P, seed=0):
    """(keys (n,) int32, payloads (P, n) float32): the input of a merge
    pass with runs of B."""
    rng = np.random.default_rng([seed, KINDS.index(kind), n, B, P])
    if kind == "unique":
        keys = rng.permutation(n).astype(np.int32)
    elif kind == "equal":
        keys = np.full(n, 7, dtype=np.int32)
    else:
        keys = rng.integers(0, 4, n).astype(np.int32)
    keys = keys.reshape(-1, B)
    pays = rng.standard_normal((P, n // B, B)).astype(np.float32)
    order = np.argsort(keys, axis=1, kind="stable")
    order[1::2] = order[1::2, ::-1]
    keys = np.take_along_axis(keys, order, axis=1)
    pays = np.take_along_axis(pays, order[None], axis=2)
    return keys.reshape(n), pays.reshape(P, n)
