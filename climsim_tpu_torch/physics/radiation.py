"""Differentiable radiative-transfer solvers (counterpart of
``climsim_tpu/physics/radiation.py``): LW no-scattering and SW two-stream
adding, with their helpers.

The two solvers here, ``lw_solver_noscat`` and ``adding_sw``, are the
plain versions of the CUDA kernels behind
``ops/pallas_radiation.py::lw_solver_noscat_fast`` and ``adding_sw_fast``:
a Python loop over levels where JAX has ``lax.scan``. The TripleClouds
pair ``calc_overlap_matrices`` and ``adding_sw_tc`` is plain JAX in the
JAX package and plain torch here.

Shapes are batch-first: layers [B, nlev(, ng)], half-levels
[B, nlev+1(, ng)] with level 0 = TOA; the spectral axis ng rides along as
a trailing batch axis.
"""
from __future__ import annotations

from functools import reduce

import torch
from torch.nn import functional as F

SIGMA_SB = 5.670374419e-8
LW_DIFFUSIVITY = 1.66


def _common(*arrays) -> list[torch.Tensor]:
    """The arrays cast to their promoted dtype (the solvers' carries keep
    one dtype, as JAX's ``result_type`` cast does)."""
    dt = reduce(torch.promote_types, (a.dtype for a in arrays))
    return [a.to(dt) for a in arrays]


def interpolate_tlev(tlay: torch.Tensor, play: torch.Tensor,
                     plev: torch.Tensor) -> torch.Tensor:
    """Layer temperatures interpolated to the nlay+1 half-levels
    (physics_rad.py:17-49). tlay/play [B, nlay], plev [B, nlay+1]."""
    t_top = tlay[:, 0] + (plev[:, 0] - play[:, 0]) * \
        (tlay[:, 1] - tlay[:, 0]) / (play[:, 1] - play[:, 0])
    interior = (play[:, :-1] * tlay[:, :-1] * (plev[:, 1:-1] - play[:, 1:])
                + play[:, 1:] * tlay[:, 1:] * (play[:, :-1] - plev[:, 1:-1])) \
        / (plev[:, 1:-1] * (play[:, :-1] - play[:, 1:]))
    t_sfc = tlay[:, -1] + (plev[:, -1] - play[:, -1]) * \
        (tlay[:, -1] - tlay[:, -2]) / (play[:, -1] - play[:, -2])
    return torch.cat([t_top[:, None], interior, t_sfc[:, None]], dim=1)


def pow4(x: torch.Tensor) -> torch.Tensor:
    """x**4 as two squarings, the products XLA evaluates for an integer
    power of 4."""
    x2 = x * x
    return x2 * x2


def outgoing_lw(temp: torch.Tensor) -> torch.Tensor:
    """Blackbody OLR sigma*T^4 (physics_rad.py:51-57)."""
    return SIGMA_SB * pow4(temp)


def reftrans_lw(planck_top, planck_bot, od):
    """Pade-approximant linear-in-tau LW source terms
    (physics_rad.py:60-92). Returns (source_up, source_dn, trans_lw)."""
    od = LW_DIFFUSIVITY * od
    trans_lw = torch.exp(-od)
    coeff = 0.2 * od
    planck_fl = 0.5 * (planck_top + planck_bot)
    source_dn = (1.0 - trans_lw) * (planck_fl + coeff * planck_bot) \
        / (1.0 + coeff)
    source_up = (1.0 - trans_lw) * (planck_fl + coeff * planck_top) \
        / (1.0 + coeff)
    return source_up, source_dn, trans_lw


def lw_solver_noscat(trans_lw, source_dn, source_up, source_sfc,
                     emissivity_surf):
    """No-scattering LW adding solver (physics_rad.py:96-131), the plain
    version of kernel B12.

    trans_lw/source_* [B, nlev(, ng)], source_sfc/emissivity [B(, ng)].
    Returns (flux_dn, flux_up) at the nlev+1 half-levels, TOA first.
    """
    trans_lw, source_dn, source_up, source_sfc, emissivity_surf = _common(
        trans_lw, source_dn, source_up, source_sfc, emissivity_surf)
    nlev = trans_lw.shape[1]
    fdn = torch.zeros_like(source_sfc)
    flux_dn = [fdn]
    for j in range(nlev):
        fdn = trans_lw[:, j] * fdn + source_dn[:, j]
        flux_dn.append(fdn)
    fup = emissivity_surf * source_sfc + (1.0 - emissivity_surf) * fdn
    flux_up = [fup]
    for j in range(nlev - 1, -1, -1):
        fup = trans_lw[:, j] * fup + source_up[:, j]
        flux_up.append(fup)
    flux_up.reverse()
    return torch.stack(flux_dn, dim=1), torch.stack(flux_up, dim=1)


def calc_ref_trans_sw(mu0, od, ssa, asymmetry):
    """Meador & Weaver (1980) two-stream SW reflectance/transmittance
    (physics_rad.py:139-245), elementwise.

    Returns (ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir).
    """
    eps = 1.0e-7
    trans_dir_dir = torch.exp(-od / mu0)

    gamma1 = (8.0 - ssa * (5.0 + 3.0 * asymmetry)) * 0.25
    gamma2 = 3.0 * (ssa * (1.0 - asymmetry)) * 0.25
    gamma3 = (2.0 - 3.0 * mu0 * asymmetry) * 0.25
    gamma4 = 1.0 - gamma3
    alpha1 = gamma1 * gamma4 + gamma2 * gamma3
    alpha2 = gamma1 * gamma3 + gamma2 * gamma4

    k = torch.sqrt(torch.clamp((gamma1 - gamma2) * (gamma1 + gamma2),
                               min=1.0e-4))
    expo = torch.exp(-k * od)
    expo2 = expo ** 2
    k_2_exp = 2.0 * k * expo
    rf = 1.0 / (k + gamma1 + (k - gamma1) * expo2)

    ref_diff = gamma2 * (1.0 - expo2) * rf
    # jnp.clip(x, lo, hi) = minimum(maximum(x, lo), hi)
    trans_diff = torch.minimum(torch.clamp(k_2_exp * rf, min=0.0),
                               1.0 - ref_diff)
    trans_diff = torch.clamp(trans_diff, min=0.0)

    k_mu0 = k * mu0
    one_minus = 1.0 - k_mu0 ** 2
    safe_denom = torch.where(torch.abs(one_minus) > eps, one_minus, eps)
    rf2 = ssa * rf / safe_denom

    ref_dir = rf2 * ((1.0 - k_mu0) * (alpha2 + k * gamma3)
                     - (1.0 + k_mu0) * (alpha2 - k * gamma3) * expo2
                     - k_2_exp * (gamma3 - alpha2 * mu0) * trans_dir_dir)
    trans_dir_diff = rf2 * (k_2_exp * (gamma4 + alpha1 * mu0)
                            - trans_dir_dir
                            * ((1.0 + k_mu0) * (alpha1 + k * gamma4)
                               - (1.0 - k_mu0) * (alpha1 - k * gamma4)
                               * expo2))

    max_direct = 1.0 - trans_dir_dir
    ref_dir = torch.minimum(torch.clamp(ref_dir, min=0.0), max_direct)
    trans_dir_diff = torch.minimum(torch.clamp(trans_dir_diff, min=0.0),
                                   max_direct - ref_dir)
    return ref_diff, trans_diff, ref_dir, trans_dir_diff, trans_dir_dir


def adding_sw(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
              R, T, ref_dir, T_dir_diff, T_dir_dir):
    """Two-sweep SW adding solver (ecRad-TripleClouds form,
    physics_rad.py:250-420), the plain version of kernel B11. Layer arrays
    [B, nlev(, ng)], TOA first; surface arrays [B(, ng)].

    The down sweep uses the energy-conserving direct-reflection term
    tdir*albedodir*R (ecRad radiation_mcica_sw), as the JAX package does,
    not the reference's T*albedodir*R.

    Returns (flux_up, flux_dn_diffuse, flux_dn_direct) at half-levels.
    """
    (incoming_toa, albedo_surf_diffuse, albedo_surf_direct, R, T, ref_dir,
     T_dir_diff, T_dir_dir) = _common(
        incoming_toa, albedo_surf_diffuse, albedo_surf_direct, R, T,
        ref_dir, T_dir_diff, T_dir_dir)
    nlev = R.shape[1]
    # up sweep: albedo of the system below every half-level
    alb, albdir = albedo_surf_diffuse, albedo_surf_direct
    albs, albdirs = [alb] * (nlev + 1), [albdir] * (nlev + 1)
    for j in range(nlev - 1, -1, -1):
        Rj, Tj = R[:, j], T[:, j]
        inv = 1.0 / (1.0 - alb * Rj)
        albdir = ref_dir[:, j] + (T_dir_dir[:, j] * albdir
                                  + T_dir_diff[:, j] * alb) * Tj * inv
        alb = Rj + Tj * Tj * alb * inv
        albs[j], albdirs[j] = alb, albdir
    # down sweep: direct and diffuse downwelling flux
    fdndir = incoming_toa
    fdndiff = torch.zeros_like(incoming_toa)
    fups, fdiffs, fdirs = [incoming_toa * albdirs[0]], [fdndiff], [fdndir]
    for j in range(nlev):
        Rj, Tj, tdj = R[:, j], T[:, j], T_dir_dir[:, j]
        alb1, adir1 = albs[j + 1], albdirs[j + 1]
        fdndiff = (Tj * fdndiff + fdndir * (tdj * adir1 * Rj
                                            + T_dir_diff[:, j])) \
            / (1.0 - Rj * alb1)
        fdndir = fdndir * tdj
        fups.append(fdndir * adir1 + fdndiff * alb1)
        fdiffs.append(fdndiff)
        fdirs.append(fdndir)
    return (torch.stack(fups, dim=1), torch.stack(fdiffs, dim=1),
            torch.stack(fdirs, dim=1))


def calc_overlap_matrices(region_fracs: torch.Tensor,
                          overlap_param: torch.Tensor,
                          cloud_fraction_threshold: float = 1.0e-20
                          ) -> torch.Tensor:
    """Directional TripleClouds overlap matrices (Shonk et al. 2010;
    physics_rad.py:688-872), built for every interface at once: each
    interface needs only the region fractions of its two layers.

    region_fracs [B, nlev, nreg] (region 0 the clear sky, TOA first);
    overlap_param [B, nlev-1], the beta overlap of each interior
    interface. Returns v [B, nlev+1, nreg, nreg] with ``v[..., jl, ju]``
    the share of the downwelling flux leaving region ``ju`` of the layer
    above interface ``jlev`` that enters region ``jl`` below it;
    interface 0 is the TOA and interface nlev the surface, each with a
    single clear region on its far side."""
    B, nlev, nreg = region_fracs.shape
    dt, dev = region_fracs.dtype, region_fracs.device
    # the threshold rounds to a half-precision input's dtype, as JAX's
    # weakly typed scalar does
    th = float(torch.tensor(cloud_fraction_threshold, dtype=dt))
    clear = torch.zeros((B, 1, nreg), dtype=dt, device=dev)
    clear[:, :, 0] = 1.0
    frac_upper = torch.cat([clear, region_fracs], dim=1)     # [B, L+1, R]
    frac_lower = torch.cat([region_fracs, clear], dim=1)
    # the TOA and the surface take op 1 (one region on the far side);
    # cloudy regions op0^2 where op0 >= 0, else op0 (physics_rad.py:
    # 768-773)
    op0 = F.pad(overlap_param, (1, 1), value=1.0)
    op_cld = torch.where(op0 >= 0.0, op0 * op0, op0)
    op = torch.cat([op0[..., None],
                    op_cld[..., None].expand(B, nlev + 1, nreg - 1)],
                   dim=-1)                                   # [B, L+1, R]
    oxm = op * torch.minimum(frac_upper, frac_lower)
    denom = 1.0 - oxm.sum(-1)
    factor = torch.where(denom >= th,
                         1.0 / torch.clamp(denom, min=th),
                         torch.zeros((), dtype=dt, device=dev))
    ru = frac_upper - oxm
    rl = frac_lower - oxm
    eye = torch.eye(nreg, dtype=dt, device=dev)
    # overlap[ju, jl] = factor ru[ju] rl[jl] + diag(oxm)
    overlap = factor[..., None, None] * ru[..., :, None] * rl[..., None, :] \
        + oxm[..., :, None] * eye
    # v[jl, ju] = overlap[ju, jl] / max(frac_upper[ju], th)
    inv_fu = 1.0 / torch.clamp(frac_upper, min=th)
    return overlap.transpose(-1, -2) * inv_fu[..., None, :]


def adding_sw_tc(incoming_toa, albedo_surf_diffuse, albedo_surf_direct,
                 R, T, ref_dir, T_dir_diff, T_dir_dir, V):
    """TripleClouds SW adding solver with inter-region overlap mixing
    (physics_rad.py:421-532 ``adding_tc_sw_batchlast_opt``). The up sweep
    maps the albedos below an interface into the regions of the layer
    above it (``a V``), the down sweep the downwelling direct and diffuse
    fluxes into the regions of the layer below (``V f``); with ``V = I``
    it is the ICA solver but for the down sweep's direct-reflection term,
    which keeps the reference's T*albedodir*R here, as the JAX package's
    does.

    incoming_toa, albedo_surf_* [B, nreg] (g-points folded into B);
    R, T, ref_dir, T_dir_diff, T_dir_dir [B, nlev, nreg], TOA first;
    V [B, nlev+1, nreg, nreg] from :func:`calc_overlap_matrices` (the
    surface interface unused). Returns (flux_up, flux_dn_diffuse,
    flux_dn_direct), each [B, nlev+1, nreg]. The level loops run on one
    ``unbind`` of each input (ROADMAP C.1)."""
    (incoming_toa, albedo_surf_diffuse, albedo_surf_direct, R, T, ref_dir,
     T_dir_diff, T_dir_dir, V) = _common(
        incoming_toa, albedo_surf_diffuse, albedo_surf_direct, R, T,
        ref_dir, T_dir_diff, T_dir_dir, V)
    nlev = R.shape[1]
    Rl, Tl, rdir, tdd, tdir = (a.unbind(1) for a in (R, T, ref_dir,
                                                     T_dir_diff, T_dir_dir))
    Vl = V[:, :-1].unbind(1)                     # nlev x [B, nreg, nreg]
    # up sweep; new[ju] = sum_jl a[jl] V[jl, ju]
    alb, albdir = albedo_surf_diffuse, albedo_surf_direct
    albs, albdirs = [alb] * (nlev + 1), [albdir] * (nlev + 1)
    for j in range(nlev - 1, -1, -1):
        Rj, Tj = Rl[j], Tl[j]
        inv = 1.0 / (1.0 - alb * Rj)
        albdir_new = rdir[j] + (tdir[j] * albdir + tdd[j] * alb) * Tj * inv
        alb_new = Rj + Tj * Tj * alb * inv
        albdir = torch.einsum("bl,blu->bu", albdir_new, Vl[j])
        alb = torch.einsum("bl,blu->bu", alb_new, Vl[j])
        albs[j], albdirs[j] = alb, albdir
    # down sweep; new[jl] = sum_ju V[jl, ju] f[ju]
    fdndir = incoming_toa
    fdndiff = torch.zeros_like(incoming_toa)
    fups, fdiffs, fdirs = [incoming_toa * albdirs[0]], [fdndiff], [fdndir]
    for j in range(nlev):
        Rj, Tj = Rl[j], Tl[j]
        alb1, adir1 = albs[j + 1], albdirs[j + 1]
        fdndiff = (Tj * fdndiff + fdndir * (Tj * adir1 * Rj + tdd[j])) \
            / (1.0 - Rj * alb1)
        fdndir = fdndir * tdir[j]
        fdndir = torch.einsum("blu,bu->bl", Vl[j], fdndir)
        fdndiff = torch.einsum("blu,bu->bl", Vl[j], fdndiff)
        fups.append(fdndir * adir1 + fdndiff * alb1)
        fdiffs.append(fdndiff)
        fdirs.append(fdndir)
    return (torch.stack(fups, dim=1), torch.stack(fdiffs, dim=1),
            torch.stack(fdirs, dim=1))


def stratified_sample(p: torch.Tensor, G: int) -> torch.Tensor:
    """Deterministically assign ``G`` spectral points among N subgrid
    states proportional to the area fractions ``p`` [B, N]
    (largest-remainder apportionment, physics_rad.py:533-589).

    Returns int32 indices [B, G]. Both rankings are stable sorts, as
    ``jnp.argsort`` is: among equal remainders the lower state index wins
    the extra point, so the port picks the JAX package's states on ties.
    """
    exact = p * G
    floors = torch.floor(exact).to(torch.int32)
    remainders = exact - floors
    deficit = G - floors.sum(-1, keepdim=True)
    order = torch.argsort(-remainders, dim=-1, stable=True)   # descending
    rank = torch.argsort(order, dim=-1, stable=True)
    counts = floors + (rank < deficit).to(torch.int32)
    # state index of spectral point g = #states whose cumulative count <= g
    ends = torch.cumsum(counts, dim=-1)
    g = torch.arange(G, dtype=ends.dtype, device=p.device)
    return (g[None, :, None] >= ends[:, None, :]).sum(-1).to(torch.int32)


def take_small_axis(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the (small) last axis: x [..., N] at idx [..., G] ->
    [..., G]. A select-and-reduce with ``torch.where`` (not a 0/1
    multiply): lanes not selected may hold non-finite values (degenerate
    zero-area subgrid regions) that a one-hot product would turn into
    0*NaN."""
    N = x.shape[-1]
    ids = torch.arange(N, dtype=idx.dtype, device=idx.device)
    oh = idx[..., None] == ids                          # [..., G, N]
    return torch.where(oh, x[..., None, :], torch.zeros((), dtype=x.dtype,
                                                         device=x.device)
                       ).sum(-1)


def heating_rate(flux_net: torch.Tensor, dp: torch.Tensor,
                 grav: float = 9.80616,
                 cp: float = 1.00464e3) -> torch.Tensor:
    """Net downward flux at half-levels [B, nlev+1] -> layer temperature
    tendency [K/s]: dT/dt = g/cp * (F_net(top) - F_net(bottom)) / dp."""
    dF = flux_net[:, :-1] - flux_net[:, 1:]
    return grav / cp * dF / dp
