"""The force's k-space kernel (ops/kspace.py, csrc/kspace_grad.cu).

On the CPU, force_grad_k takes its plain version, which is held here bit
for bit against the chain it replaces on the card: the acceleration
transfer of kernels.apply_kernel_transfer (deconvolution, potential,
gradient, Nyquist mask), with no Norm (the force's c2r is
unnormalised, ops/fft.py; the kernel is launched with norm 1.0), for
every kernel type and axis, on cubic and non-cubic meshes and on a k
shard's sliced tables (parallel.pfft.KShard). The force's CPU path takes
the plain version, and equals the chain through PM.c2r; the force's
k-space stage (gravity.acc_fields), which every force runs on one card
and over ranks, equals the chain through the caller's inverse on the
whole mesh, a slab's k shard and a pencil's k shard with its kz pad.

The CUDA cases hold the kernel bit-equal to the plain version on the
card for every kernel type and axis, launched with norm 1.0: on 64^3,
on (32, 48, 64), whose rows of Nz/2 + 1 = 33 modes put the kernel's
two-mode accesses across row ends, in r2c's layout (contiguous in
(x, y, z) order) and in another memory order of the axes, on
a shard and on a delta_k that is not 16-byte aligned (the kernel's
one-mode loop). They hold gravity._force_fields on the card
equal to the chain, and count the kernel's launches (3 a force). They
skip without a card and need no JAX: on a GPU machine without it the
file runs as `python -m pytest --noconftest tests/test_torch_kspace.py
-m cuda`.
"""

import numpy as np
import pytest
import torch

from fastpm_torch import gravity, kernels, prof
from fastpm_torch.mesh import PM
from fastpm_torch.ops import fft, kspace
from fastpm_torch.painter import Painter
from fastpm_torch.parallel.pfft import KShard
from fastpm_torch.store import Store

KERNEL_TYPES = sorted(kernels.KERNELS)
CPU_MESHES = [((16, 16, 16), 32.0), ((16, 24, 32), (40.0, 60.0, 80.0))]
CUDA_MESHES = [((64, 64, 64), 128.0), ((32, 48, 64), (64.0, 96.0, 128.0))]


def _delta_k(pm, seed=0):
    """The transform of a real field: a hermitian-consistent delta_k."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(pm.Nmesh).astype(np.float32))
    return pm.r2c(x.to(pm.device))


def _chain(pm, dk, d, kernel_type):
    """The unfused chain: the acceleration transfer."""
    return kernels.apply_kernel_transfer(pm, dk, kernel_type, "acc", d)


@pytest.mark.parametrize("d", [0, 1, 2])
@pytest.mark.parametrize("mesh", CPU_MESHES, ids=["cube", "box"])
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
def test_plain_matches_chain(kernel_type, mesh, d):
    pm = PM(*mesh)
    dk = _delta_k(pm)
    kept = dk.clone()
    got = kspace.force_grad_k_plain(pm, dk, d, kernel_type)
    assert torch.equal(dk, kept)
    assert torch.equal(got, _chain(pm, dk, d, kernel_type))
    # the real field: the gradient through the unnormalised c2r against
    # the transfer through PM.c2r
    want = pm.c2r(kernels.apply_kernel_transfer(pm, dk, kernel_type, "acc",
                                                d))
    assert torch.equal(fft.c2r(got, pm.Nmesh), want)


@pytest.mark.parametrize("kernel_type", ["1_4", "eastwood", "5_4"])
def test_plain_on_a_shard(kernel_type):
    """A KShard's sliced tables (y rows 5-11, z columns from 3 with the
    pencil's pad past Nz/2 + 1) give the chain's modes on the shard."""
    pm = PM(16, 32.0)
    shard = KShard(pm, 5, 7, 3, 8)
    dk = _delta_k(pm)[:, 5:12, 3:]
    dk = torch.cat([dk, torch.zeros(16, 7, 2, dtype=dk.dtype)], 2)
    assert tuple(dk.shape) == shard.kshape
    for d in range(3):
        got = kspace.force_grad_k_plain(shard, dk, d, kernel_type)
        assert torch.equal(got, _chain(shard, dk, d, kernel_type))
        assert not got[:, :, -2:].any()


def test_wrapper_on_cpu_takes_plain():
    pm = PM(16, 32.0)
    dk = _delta_k(pm)
    before = kspace.force_grad_k.launches
    for d in range(3):
        assert torch.equal(kspace.force_grad_k(pm, dk, d, "1_4"),
                           kspace.force_grad_k_plain(pm, dk, d, "1_4"))
    assert kspace.force_grad_k.launches == before
    with pytest.raises(ValueError):
        kspace.force_grad_k(pm, dk, 3, "1_4")
    with pytest.raises(ValueError):
        kspace.force_grad_k(pm, dk, 0, "2_4")


def test_memory_positions():
    """Each axis's place in memory, for the layouts cuFFT may return; a
    tensor with gaps raises."""
    t = torch.empty(4, 6, 5, dtype=torch.complex64)
    assert kspace._memory_positions(t) == [0, 1, 2]
    # memory order (z, x, y): y innermost
    t = torch.empty(5, 4, 6, dtype=torch.complex64).permute(1, 2, 0)
    assert kspace._memory_positions(t) == [1, 2, 0]
    t = torch.empty(4, 6, 8, dtype=torch.complex64)[:, :, :5]
    with pytest.raises(ValueError):
        kspace._memory_positions(t)


def test_force_fields_on_cpu_is_the_chain():
    """The CPU force (the plain version a gradient) equals the chain:
    each acceleration transfer through PM.c2r."""
    pm = PM(16, 32.0)
    dk = _delta_k(pm)
    got_dk, fields = gravity._force_fields(pm, dk, "1_4", "gaussian")
    soft = kernels.apply_softening(pm, dk, "gaussian")
    assert torch.equal(got_dk, soft)
    for d, g in enumerate(fields):
        assert torch.equal(g, pm.c2r(_chain(pm, soft, d, "1_4")))


# the k-space geometries of the stage's wiring test on PM(16, 32.0): the
# whole mesh, a slab's y shard (rank 1 of 4: y rows 4-7) and a pencil's
# shard (rank (1, 1) of a 2 x 2 grid: y rows 8-15, z columns 5-9, the
# last of them the kz pad past Nz/2 + 1 = 9)
GEOMETRIES = {"one_card": None, "slab": (4, 4), "pencil": (8, 8, 5, 5)}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
def test_stage_is_the_chain(kernel_type, geometry):
    """gravity.acc_fields, the k-space stage of every force, gives c2r of
    each acceleration transfer bit for bit, delta_k kept, one force.kspace
    and one force.c2r clock a field. c2r is the caller's: the whole
    mesh's unnormalised c2r, or on a shard the inverse along x that a
    shard's c2r_local starts with."""
    pm = PM(16, 32.0)
    dk = _delta_k(pm)
    shard = GEOMETRIES[geometry]
    if shard is None:
        kpm = pm

        def inverse(k):
            return fft.c2r(k, pm.Nmesh)
    else:
        kpm = KShard(pm, *shard)
        y0, ny, z0 = (shard + (0,))[:3]
        dk = dk[:, y0:y0 + ny, z0:]
        # the pencil's kz pad: zero modes past Nz/2 + 1
        dk = torch.cat([dk, torch.zeros(
            *dk.shape[:2], kpm.kshape[2] - dk.shape[2], dtype=dk.dtype)], 2)

        def inverse(k):
            return torch.fft.ifft(k, dim=0)
    assert tuple(dk.shape) == kpm.kshape
    kept = dk.clone()
    prof.reset()
    try:
        fields = gravity.acc_fields(kpm, dk, kernel_type, inverse)
        counts = {n: c.count for n, c in prof._clocks.items()}
    finally:
        prof.reset()
    assert counts == {"force.kspace": 3, "force.c2r": 3}
    assert torch.equal(dk, kept)
    assert len(fields) == 3
    for d, f in enumerate(fields):
        assert torch.equal(f, inverse(_chain(kpm, dk, d, kernel_type)))
        if geometry == "pencil":
            assert not f[:, :, -1].any()


# ---- on the card ----

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", CUDA_MESHES, ids=["cube", "box"])
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
def test_kernel_bit_equal_on_cuda(kernel_type, mesh):
    dev = _cuda()
    pm = PM(*mesh, device=dev)
    dk = _delta_k(pm)
    # r2c's layout: contiguous in (x, y, z) order (ops/fft.py)
    assert dk.is_contiguous()
    kept = dk.clone()
    # the same modes laid out in (y, z, x) memory order
    other = dk.permute(1, 2, 0).contiguous().permute(2, 0, 1)
    before = kspace.force_grad_k.launches
    for d in range(3):
        want = kspace.force_grad_k_plain(pm, dk, d, kernel_type)
        assert torch.equal(kspace.force_grad_k(pm, dk, d, kernel_type), want)
        assert torch.equal(kspace.force_grad_k(pm, other, d, kernel_type),
                           want)
    torch.cuda.synchronize()
    assert kspace.force_grad_k.launches == before + 6
    assert torch.equal(dk, kept)


@pytest.mark.cuda
def test_kernel_on_shard_and_unaligned_on_cuda():
    dev = _cuda()
    pm = PM((32, 48, 64), (64.0, 96.0, 128.0), device=dev)
    shard = KShard(pm, 5, 7, 3)
    full = _delta_k(pm)
    dk = full[:, 5:12, 3:].contiguous()
    # one complex64 (8 bytes) into a buffer: not 16-byte aligned
    buf = torch.empty(full.numel() + 1, dtype=full.dtype, device=dev)
    odd = buf[1:].view(full.shape)
    odd.copy_(full)
    assert odd.data_ptr() % 16 == 8
    for kernel_type in ("1_4", "eastwood", "3_4"):
        for d in range(3):
            assert torch.equal(
                kspace.force_grad_k(shard, dk, d, kernel_type),
                kspace.force_grad_k_plain(shard, dk, d, kernel_type))
            assert torch.equal(
                kspace.force_grad_k(pm, odd, d, kernel_type),
                kspace.force_grad_k_plain(pm, full, d, kernel_type))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("softening", ["none", "gaussian"])
@pytest.mark.parametrize("kernel_type", ["1_4", "eastwood"])
def test_force_fields_on_cuda(kernel_type, softening):
    """_force_fields on the card against the chain on the card: delta_k
    and the three fields equal, three launches a force."""
    dev = _cuda()
    pm = PM(64, 128.0, device=dev)
    dk = _delta_k(pm)
    before = kspace.force_grad_k.launches
    got_dk, fields = gravity._force_fields(pm, dk, kernel_type, softening)
    assert kspace.force_grad_k.launches == before + 3
    soft = kernels.apply_softening(pm, dk, softening)
    assert torch.equal(got_dk, soft)
    for d, g in enumerate(fields):
        assert torch.equal(g, pm.c2r(_chain(pm, soft, d, kernel_type)))


@pytest.mark.cuda
def test_force_launches_on_cuda():
    """The carry and the multi-species force: one launch per axis."""
    dev = _cuda()
    pm = PM(64, 64.0, device=dev)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 64.0, (20000, 3)).astype(
        np.float32)).to(dev)
    store = Store(x=x, v=torch.zeros_like(x))
    painter = Painter(pm, "cic")
    before = kspace.force_grad_k.launches
    gravity.compute_force_carry(pm, painter, store)
    assert kspace.force_grad_k.launches == before + 3
    gravity.compute_force(pm, painter, [store])
    assert kspace.force_grad_k.launches == before + 6
