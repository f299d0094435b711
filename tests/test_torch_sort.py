"""The port's k-sorted carry sort (fastpm_torch/ops/sort.py) against the
JAX package's (fastpm_tpu/ops/sort_pallas.py, Pallas in interpret mode).

On the CPU the K7 wrapper takes its plain version, which runs the TPU
kernel's network with its tie rule, so it is held bit-identical to the
Pallas merge, payloads included, on duplicate keys. Full sorts order
equal keys in their own ways, so they are compared per key as multisets
(as tests/test_sort_pallas.py does). The JAX oracles import JAX inside
the tests; the CUDA case holds K7 against its plain version on the card,
skips without one and needs no JAX, so on a GPU machine the file runs as
`python -m pytest --noconftest tests/test_torch_sort.py -m cuda`.
"""

import numpy as np
import pytest
import torch

from fastpm_torch.ops import sort


def _bitonic_pairs(rng, n, B, P, high=10000):
    """Duplicate-heavy keys in runs of B, even runs ascending and odd runs
    descending (the input of a merge pass), and P payloads."""
    keys = rng.integers(0, high, n).astype(np.int32).reshape(-1, B)
    pays = rng.standard_normal((P, n // B, B)).astype(np.float32)
    for i in range(keys.shape[0]):
        order = np.argsort(keys[i], kind="stable")
        if i % 2:
            order = order[::-1]
        keys[i] = keys[i][order]
        pays[:, i] = pays[:, i][:, order]
    return keys.reshape(n), pays.reshape(P, n)


def _ksorted_keys(rng, n, D):
    """Unique int32 keys whose sorted place is within about D of their
    row (tests/test_sort_pallas.py:13)."""
    vals = np.arange(n, dtype=np.int64) * 7 + rng.integers(-7 * D, 7 * D, n)
    ranks = np.empty(n, dtype=np.int32)
    ranks[np.argsort(vals, kind="stable")] = np.arange(n, dtype=np.int32)
    return ranks


def _per_key_multisets(key, *payloads):
    return sorted(zip(key.tolist(), *(p.tolist() for p in payloads)))


@pytest.mark.parametrize("P", [1, 6])
def test_merge_plain_bit_identical_to_pallas(P):
    import jax.numpy as jnp
    from fastpm_tpu.ops.sort_pallas import make_merge_pairs_fn
    rng = np.random.default_rng(3 + P)
    n, B = 4096, 512
    # few distinct keys: many ties, where only the tie rule decides
    keys, pays = _bitonic_pairs(rng, n, B, P, high=40)
    want = make_merge_pairs_fn(n, B, P, interpret=True)(
        jnp.asarray(keys), *(jnp.asarray(p) for p in pays))
    got = sort.merge_pairs(torch.from_numpy(keys),
                           *(torch.from_numpy(p) for p in pays), B=B)
    assert len(got) == 1 + P
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.diff(got[0].numpy().reshape(-1, 2 * B), axis=1) >= 0).all()


def test_sort_ksorted_bit_identical_on_unique_keys():
    import jax
    import jax.numpy as jnp
    from fastpm_tpu.ops.sort_pallas import sort_ksorted as jsort_ksorted
    rng = np.random.default_rng(0)
    n, B = 16384, 1024
    key = _ksorted_keys(rng, n, B // 3)
    pays = rng.standard_normal((3, n)).astype(np.float32)
    want, wok = jax.jit(lambda ops: jsort_ksorted(ops, B, interpret=True))(
        (jnp.asarray(key),) + tuple(jnp.asarray(p) for p in pays))
    got, ok = sort.sort_ksorted(
        [torch.from_numpy(key)] + [torch.from_numpy(p) for p in pays], B)
    assert bool(ok) and bool(wok)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[0].numpy(), np.sort(key))


def test_sort_ksorted_duplicates_match_jax_per_key():
    import jax
    import jax.numpy as jnp
    from fastpm_tpu.ops.sort_pallas import sort_ksorted as jsort_ksorted
    rng = np.random.default_rng(1)
    n, B = 8192, 512
    key = (np.sort(rng.integers(0, 600, n))
           + rng.integers(-2, 3, n)).astype(np.int32)
    pay = rng.permutation(n).astype(np.float32)
    want, wok = jax.jit(lambda ops: jsort_ksorted(ops, B, interpret=True))(
        (jnp.asarray(key), jnp.asarray(pay)))
    (gk, gp), ok = sort.sort_ksorted(
        [torch.from_numpy(key), torch.from_numpy(pay)], B)
    assert bool(ok) and bool(wok)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(want[0]))
    assert (_per_key_multisets(gk.numpy(), gp.numpy())
            == _per_key_multisets(np.asarray(want[0]), np.asarray(want[1])))


def test_sort_maybe_ksorted_falls_back_on_a_permutation():
    rng = np.random.default_rng(2)
    n, B = 8192, 512
    key = torch.from_numpy(rng.permutation(n).astype(np.int32))
    pays = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2)]
    _, ok = sort.sort_ksorted([key] + pays, B)
    assert not bool(ok)
    before = sort.sort_maybe_ksorted.fallbacks
    got = sort.sort_maybe_ksorted([key] + pays, B)
    assert sort.sort_maybe_ksorted.fallbacks == before + 1
    want, order = torch.sort(key)
    assert torch.equal(got[0], want)
    for g, p in zip(got[1:], pays):
        assert torch.equal(g, p[order])


def test_bad_shapes_raise():
    key = torch.zeros(4096, dtype=torch.int32)
    pay = torch.zeros(4096)
    for B in (300, 64):
        with pytest.raises(ValueError, match="power of two"):
            sort.merge_pairs(key, pay, B=B)
    with pytest.raises(ValueError, match="multiple of 2B"):
        sort.merge_pairs(torch.zeros(5000, dtype=torch.int32), B=512)
    with pytest.raises(ValueError, match="multiple of 2B"):
        sort.sort_ksorted([torch.zeros(5000, dtype=torch.int32)], 512)
    with pytest.raises(ValueError, match="at most 8"):
        sort.merge_pairs(key, *[pay] * 9, B=512)
    with pytest.raises(ValueError, match="int32"):
        sort.merge_pairs(key.long(), pay, B=512)
    with pytest.raises(ValueError, match="float32"):
        sort.merge_pairs(key, pay[:100], B=512)


def test_carry_sort_pads_like_prepare_carry():
    """carry_sort(sort_block=256) on n = 3000 (not a multiple of 2B: the
    padding goes through the merges) against the JAX
    make_prepare_carry_fn(sort_block=256): the same cell keys in order,
    and the same (x, v) rows."""
    import jax
    import jax.numpy as jnp
    from fastpm_tpu.mesh import PM as JPM
    from fastpm_tpu.ops.paint_pallas import make_prepare_carry_fn
    from fastpm_torch.ops import cic
    jpm = JPM(32, 32.0)
    rng = np.random.default_rng(3)
    n = 3000
    x = (rng.random((n, 3)) * 32).astype(np.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    _, jx, jv, _ = jax.jit(make_prepare_carry_fn(jpm, sort_block=256))(
        jnp.asarray(x), jnp.asarray(v))
    jx, jv = np.array(jx), np.array(jv)
    for block in (256, None):
        xs, vs = sort.carry_sort(torch.from_numpy(x), torch.from_numpy(v),
                                 jpm.Nmesh, jpm.InvCellSize, block)
        assert xs.shape == (n, 3) and vs.shape == (n, 3)
        keys = cic.cell_key(xs, jpm.Nmesh, jpm.InvCellSize).numpy()
        np.testing.assert_array_equal(keys, cic.cell_key(
            torch.from_numpy(jx), jpm.Nmesh, jpm.InvCellSize).numpy())
        assert (np.diff(keys) >= 0).all()
        a = np.lexsort(xs.numpy().T)
        b = np.lexsort(jx.T)
        np.testing.assert_array_equal(xs.numpy()[a], jx[b])
        np.testing.assert_array_equal(vs.numpy()[a], jv[b])


@pytest.mark.cuda
def test_merge_matches_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    # 2B at, below and above the kernel's shared-memory tile, P = 0..8
    for n, B, P in ((8192, 128, 1), (16384, 1024, 6), (65536, 4096, 8),
                    (65536, 8192, 0)):
        keys, pays = _bitonic_pairs(rng, n, B, P, high=50)
        cols = [torch.from_numpy(keys).to(dev)] + [
            torch.from_numpy(p).to(dev) for p in pays]
        before = sort.merge_pairs.launches
        got = sort.merge_pairs(*cols, B=B)
        torch.cuda.synchronize()
        assert sort.merge_pairs.launches == before + 1
        want = sort.merge_pairs_plain(*cols, B=B)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the k-sorted sort and the padded carry sort on the card
    key = torch.from_numpy(_ksorted_keys(rng, 1 << 16, 300)).to(dev)
    idx = torch.arange(1 << 16, device=dev, dtype=torch.float32)
    (k, i), ok = sort.sort_ksorted([key, idx], 1024)
    assert bool(ok)
    assert torch.equal(k, torch.sort(key).values)
    assert torch.equal(key[i.long()], k)
    x = torch.rand((3000, 3), device=dev) * 32
    v = torch.randn((3000, 3), device=dev)
    xs, vs = sort.carry_sort(x, v, (32,) * 3, (1.0,) * 3, 256)
    xf, vf = sort.carry_sort(x, v, (32,) * 3, (1.0,) * 3)
    a = np.lexsort(xs.cpu().numpy().T)
    b = np.lexsort(xf.cpu().numpy().T)
    np.testing.assert_array_equal(xs.cpu().numpy()[a], xf.cpu().numpy()[b])
    np.testing.assert_array_equal(vs.cpu().numpy()[a], vf.cpu().numpy()[b])
