"""HEALPix RING and NEST pixelization and the lightcone's shell maps
(port of fastpm_tpu/healpix.py).

Standard HEALPix math (Gorski et al. 2005), vectorized in numpy float64
on the host (the exact path, which the reference's chealpix goldens
pin), and a float32 NEST path on the rows' device with a conservative
boundary-risk flag (vec2pix_nest_device) that paint_hpmap_nest_device
patches with the host path.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nside2npix", "ang2pix_ring", "vec2pix_ring",
           "ang2pix_nest", "vec2pix_nest", "paint_hpmap_nest",
           "paint_hpmap", "vec2pix_nest_device", "paint_hpmap_nest_device"]


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def ang2pix_ring(nside: int, theta, phi):
    """Colatitude theta [0, pi], longitude phi [0, 2pi) -> RING pixel."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) * (2.0 / np.pi)  # in [0,4)

    pix = np.empty(theta.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    # equatorial region
    if np.any(eq):
        temp1 = nside * (0.5 + tt[eq])
        temp2 = nside * z[eq] * 0.75
        jp = (temp1 - temp2).astype(np.int64)  # ascending edge line
        jm = (temp1 + temp2).astype(np.int64)  # descending edge line
        ir = nside + 1 + jp - jm               # ring number counted from z=2/3
        kshift = 1 - (ir & 1)
        ip = (jp + jm - nside + kshift + 1) // 2
        ip = np.mod(ip, 4 * nside)
        pix[eq] = nside * (nside - 1) * 2 + (ir - 1) * 4 * nside + ip

    pol = ~eq
    if np.any(pol):
        tp = tt[pol] - np.floor(tt[pol])
        tmp = nside * np.sqrt(3 * (1 - za[pol]))
        jp = (tp * tmp).astype(np.int64)
        jm = ((1.0 - tp) * tmp).astype(np.int64)
        ir = jp + jm + 1                       # ring number from the pole
        ip = (tt[pol] * ir).astype(np.int64)
        ip = np.mod(ip, 4 * ir)
        north = z[pol] > 0
        ppix = np.empty(ir.shape, dtype=np.int64)
        ppix[north] = 2 * ir[north] * (ir[north] - 1) + ip[north]
        ppix[~north] = (12 * nside * nside - 2 * ir[~north] * (ir[~north] + 1)
                        + ip[~north])
        pix[pol] = ppix
    return pix


def vec2pix_ring(nside: int, vec):
    """Unit(ish) vectors (N,3) -> RING pixels."""
    vec = np.asarray(vec, dtype=np.float64)
    r = np.sqrt((vec ** 2).sum(axis=-1))
    theta = np.arccos(np.clip(vec[..., 2] / np.where(r > 0, r, 1), -1, 1))
    phi = np.arctan2(vec[..., 1], vec[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return ang2pix_ring(nside, theta, phi)


def _spread_bits(v):
    """Interleave-ready bit spread: bit i of v moves to bit 2i
    (supports nside up to 2^16)."""
    v = v.astype(np.int64)
    v = (v | (v << 16)) & 0x0000FFFF0000FFFF
    v = (v | (v << 8)) & 0x00FF00FF00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v << 2)) & 0x3333333333333333
    v = (v | (v << 1)) & 0x5555555555555555
    return v


def ang2pix_nest(nside: int, theta, phi):
    """Colatitude/longitude -> NESTED pixel (standard HEALPix face +
    bit-interleave construction, Gorski et al. 2005; the scheme the
    reference's lightcone maps use, io.c:1130 vec2pix_nest64)."""
    theta = np.asarray(theta, dtype=np.float64)
    phi = np.asarray(phi, dtype=np.float64)
    z = np.cos(theta)
    za = np.abs(z)
    tt = np.mod(phi, 2 * np.pi) * (2.0 / np.pi)    # [0, 4)

    face = np.empty(theta.shape, dtype=np.int64)
    ix = np.empty(theta.shape, dtype=np.int64)
    iy = np.empty(theta.shape, dtype=np.int64)

    eq = za <= 2.0 / 3.0
    if np.any(eq):
        temp1 = nside * (0.5 + tt[eq])
        temp2 = nside * z[eq] * 0.75
        jp = (temp1 - temp2).astype(np.int64)
        jm = (temp1 + temp2).astype(np.int64)
        ifp = jp // nside
        ifm = jm // nside
        f = np.where(ifp == ifm, (ifp & 3) + 4,
                     np.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
        face[eq] = f
        ix[eq] = jm & (nside - 1)
        iy[eq] = nside - (jp & (nside - 1)) - 1

    pol = ~eq
    if np.any(pol):
        ntt = np.minimum(tt[pol].astype(np.int64), 3)
        tp = tt[pol] - ntt
        tmp = nside * np.sqrt(3.0 * (1.0 - za[pol]))
        jp = np.minimum((tp * tmp).astype(np.int64), nside - 1)
        jm = np.minimum(((1.0 - tp) * tmp).astype(np.int64), nside - 1)
        north = z[pol] >= 0
        face[pol] = np.where(north, ntt, ntt + 8)
        ix[pol] = np.where(north, nside - jm - 1, jp)
        iy[pol] = np.where(north, nside - jp - 1, jm)

    return (face * (nside * nside)
            + _spread_bits(ix) + (_spread_bits(iy) << 1))


def vec2pix_nest(nside: int, vec):
    """Vectors (N,3) -> NESTED pixels."""
    vec = np.asarray(vec, dtype=np.float64)
    r = np.sqrt((vec ** 2).sum(axis=-1))
    theta = np.arccos(np.clip(vec[..., 2] / np.where(r > 0, r, 1), -1, 1))
    phi = np.arctan2(vec[..., 1], vec[..., 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    return ang2pix_nest(nside, theta, phi)


def paint_hpmap_nest(pos, aemit, v, mass, nside: int, nslices: int):
    """Paint lightcone particles onto HEALPix shell maps exactly as the
    reference (fastpm_snapshot_paint_hpmap, io.c:1105-1227): NEST
    pixels, slice_id = int(aemit * nslices) WITHOUT clipping (aemit = 1
    opens an extra slice), mass and radial momentum accumulated per
    (slice, pixel), duplicate pixels combined.

    Returns (ids, mass_map, rmom_map, aemit_mid) sorted by id."""
    pos = np.asarray(pos, dtype=np.float64)
    aemit = np.asarray(aemit, dtype=np.float64)
    npix = nside2npix(nside)
    islice = (aemit * nslices).astype(np.int64)
    ipix = vec2pix_nest(nside, pos)
    ids = islice * npix + ipix
    r = np.sqrt((pos ** 2).sum(axis=-1))
    vv = np.asarray(v, dtype=np.float64)
    rmom = mass * (vv * pos).sum(axis=-1) / np.where(r > 0, r, 1.0)

    uids, inverse = np.unique(ids, return_inverse=True)
    mass_map = np.zeros(len(uids))
    np.add.at(mass_map, inverse, np.broadcast_to(
        np.asarray(mass, dtype=np.float64), len(ids)))
    rmom_map = np.zeros(len(uids))
    np.add.at(rmom_map, inverse, rmom)
    amid = (uids // npix + 0.5) / nslices
    return uids, mass_map, rmom_map, amid


def paint_hpmap(pos, aemit, nside: int, nslices: int, weights=None):
    """Paint lightcone particles onto HEALPix shell maps
    (fastpm_snapshot_paint_hpmap, io.c:1073-1227).

    Returns (ids, values, aemit_mid) arrays where id = slice * npix + ipix
    and value is the summed weight in that (slice, pixel) cell; duplicate
    pixels are combined.
    """
    pos = np.asarray(pos, dtype=np.float64)
    aemit = np.asarray(aemit, dtype=np.float64)
    npix = nside2npix(nside)
    edges = np.linspace(0.0, 1.0, nslices + 1)
    islice = np.clip(np.searchsorted(edges, aemit, side="right") - 1,
                     0, nslices - 1)
    ipix = vec2pix_ring(nside, pos)
    ids = islice.astype(np.int64) * npix + ipix
    w = (np.ones(len(pos)) if weights is None
         else np.asarray(weights, dtype=np.float64))
    uids, inverse = np.unique(ids, return_inverse=True)
    values = np.zeros(len(uids))
    np.add.at(values, inverse, w)
    amid = 0.5 * (edges[(uids // npix)] + edges[(uids // npix) + 1])
    return uids, values, amid


# ---------------------------------------------------------------------------
# Device NEST shell maps with exact-host patching
#
# The pixel id is a discretized function of the float32 position:
# computing it in float32 risks flipping a particle across a pixel
# boundary relative to the host float64 path. vec2pix_nest_device
# computes float32 pixels TOGETHER with a conservative "risky" flag at
# every discretization site (floor and region-test inputs within an
# error-bound margin of a boundary); paint_hpmap_nest_device recomputes
# only the flagged rows with the host path and patches them in. The
# flag only picks which rows get the host recompute, so a wider margin
# changes no result, only host work.

# absolute error bounds of the float32 chain, calibrated against float64
# on 5e5 random clouds (max observed: tt 3.5e-7, z 1.4e-7) with >10x
# headroom for the platform's transcendentals (CUDA's atan2f and sqrtf
# among them)
_M_TT = 4e-6     # tt = phi * 2/pi  in [0, 4)
_M_Z = 2e-6      # z = zc / r       in [-1, 1]


def _spread_bits_device(v):
    """int32 bit spread (nside <= 8192: ix < 2^13 -> result < 2^26)."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def vec2pix_nest_device(nside: int, pos: torch.Tensor):
    """float32 NEST pixels (int32) of (N, 3) float32 positions on their
    device, and a conservative boundary-risk flag: rows where the
    float32 result could differ from the float64 host path
    (vec2pix_nest). Every actual mismatch is flagged. Needs nside <=
    8192 (int32 pixel ids)."""
    if nside > 8192:
        raise ValueError("device NEST path supports nside <= 8192")
    f32 = torch.float32
    x, y, zc = pos[:, 0], pos[:, 1], pos[:, 2]
    r = torch.sqrt(x * x + y * y + zc * zc)
    z = zc / torch.where(r > 0, r, torch.ones_like(r))
    phi = torch.atan2(y, x)
    phi = torch.where(phi < 0, phi + float(np.float32(2 * np.pi)), phi)
    tt = torch.clamp(phi * float(np.float32(2.0 / np.pi)),
                     max=float(np.float32(3.9999995)))
    za = torch.abs(z)

    def fd(t):  # distance to the nearest integer
        return torch.abs(t - torch.round(t))

    ns = float(nside)
    eq = za <= float(np.float32(2.0 / 3.0))

    # equatorial face
    temp1 = ns * (0.5 + tt)
    temp2 = ns * z * 0.75
    f_jp = temp1 - temp2
    f_jm = temp1 + temp2
    jp_e = f_jp.to(torch.int32)
    jm_e = f_jm.to(torch.int32)
    ifp = jp_e // nside
    ifm = jm_e // nside
    face_eq = torch.where(ifp == ifm, (ifp & 3) + 4,
                          torch.where(ifp < ifm, ifp & 3, (ifm & 3) + 8))
    ix_eq = jm_e & (nside - 1)
    iy_eq = nside - (jp_e & (nside - 1)) - 1
    m_f = (float(np.float32(ns * np.float32(_M_TT + 0.75 * _M_Z)))
           + torch.abs(f_jp) * float(np.float32(3e-7)))
    risky_eq = (fd(f_jp) < m_f) | (fd(f_jm) < m_f)

    # polar faces
    ntt = torch.clamp(tt.to(torch.int32), max=3)
    tp = tt - ntt.to(f32)
    s3 = torch.sqrt(torch.clamp(3.0 * (1 - za), min=0.0))
    tmp = ns * s3
    v1 = tp * tmp
    v2 = (1.0 - tp) * tmp
    jp_p = torch.clamp(v1.to(torch.int32), max=nside - 1)
    jm_p = torch.clamp(v2.to(torch.int32), max=nside - 1)
    north = z >= 0
    face_pol = torch.where(north, ntt, ntt + 8)
    ix_pol = torch.where(north, nside - jm_p - 1, jp_p)
    iy_pol = torch.where(north, nside - jp_p - 1, jm_p)
    # d(tmp)/d(za) = 1.5 * ns / s3; margin through the sqrt
    m_s3 = float(np.float32(1.5 * _M_Z)) / torch.clamp(s3, min=1e-3)
    m_tmp = ns * (m_s3 + s3 * float(np.float32(3e-7)))
    m_v1 = (tmp * float(np.float32(_M_TT)) + tp * m_tmp
            + torch.abs(v1) * float(np.float32(3e-7)))
    m_v2 = (tmp * float(np.float32(_M_TT)) + (1 - tp) * m_tmp
            + torch.abs(v2) * float(np.float32(3e-7)))
    risky_pol = ((fd(tt) < float(np.float32(_M_TT))) | (fd(v1) < m_v1)
                 | (fd(v2) < m_v2) | (torch.abs(z) < 1e-6))

    face = torch.where(eq, face_eq, face_pol)
    ix = torch.where(eq, ix_eq, ix_pol)
    iy = torch.where(eq, iy_eq, iy_pol)
    pix = (face * (nside * nside) + _spread_bits_device(ix)
           + (_spread_bits_device(iy) << 1))
    risky = torch.where(eq, risky_eq, risky_pol) | (
        torch.abs(za - float(np.float32(2.0 / 3.0))) < float(np.float32(_M_Z)))
    return pix, risky


def paint_hpmap_nest_device(x: torch.Tensor, aemit: torch.Tensor,
                            v: torch.Tensor, mass, nside: int,
                            nslices: int):
    """NEST shell maps as paint_hpmap_nest paints them, on the rows'
    device: float32 pixels and risky flags (vec2pix_nest_device), the
    host float64 recompute of ONLY the flagged rows (their pixel and
    slice), then a sort by the int64 key slice * npix + pixel and
    segment sums. x (N, 3), aemit (N,), v (N, 3) float32 tensors; mass
    the scalar particle mass.

    Returns (ids, mass_map, rmom_map, amid) numpy arrays sorted by id,
    equal in ids and counts to paint_hpmap_nest (mass_map = count *
    mass); rmom sums in float32 on the device. paint_hpmap_nest_device
    .flagged holds the rows the last call recomputed on the host."""
    npix = nside2npix(nside)
    pix, risky = vec2pix_nest_device(nside, x)
    fs = aemit * float(nslices)
    islice = fs.to(torch.int32)
    risky |= torch.abs(fs - torch.round(fs)) < float(
        np.float32(nslices) * np.float32(5e-7))
    r = torch.sqrt(torch.sum(x * x, dim=-1))
    rmom = torch.sum(v * x, dim=-1) / torch.where(r > 0, r,
                                                  torch.ones_like(r))
    ridx = torch.nonzero(risky).reshape(-1)
    paint_hpmap_nest_device.flagged = int(ridx.shape[0])
    if paint_hpmap_nest_device.flagged:
        xr = x[ridx].cpu().numpy().astype(np.float64)
        ar = aemit[ridx].cpu().numpy().astype(np.float64)
        pix[ridx] = torch.from_numpy(
            vec2pix_nest(nside, xr).astype(np.int32)).to(x.device)
        islice[ridx] = torch.from_numpy(
            (ar * nslices).astype(np.int32)).to(x.device)
    key, order = torch.sort(islice.to(torch.int64) * npix + pix, stable=True)
    uids, inverse, counts = torch.unique_consecutive(
        key, return_inverse=True, return_counts=True)
    rsum = torch.zeros(uids.shape[0], dtype=torch.float32,
                       device=x.device).index_add_(0, inverse, rmom[order])
    ids = uids.cpu().numpy()
    mass_map = counts.cpu().numpy().astype(np.float64) * float(mass)
    rmom_map = rsum.cpu().numpy().astype(np.float64) * float(mass)
    amid = (ids // npix + 0.5) / nslices
    return ids, mass_map, rmom_map, amid


paint_hpmap_nest_device.flagged = 0
