#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is the online hybrid coupled step that ``bench.py`` builds
for the JAX package: the flagship BiGRU emulator (``RNNAutoreg``, nx 6,
nneur 192/192, nh_mem 16, bf16 policy, the fused channel-major kernel)
inside ``HybridLoop`` (spherical FV transport through the fused
multi-tracer stencil, water and energy fixers) on a 120 x 180 proxy grid
of 21,600 columns and 60 levels. Weights are random, from a seed.

Phases (any failure exits non-zero):
  1. the card's name and power limit; build the CUDA kernels (one nvcc
     per source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (and a ragged batch);
  3. 20 coupled steps at 21,600 columns, with the launch counters set to
     0 just before and read just after: each kernel must launch 20 times;
  4. 3 coupled steps at 384 columns on the card and on the CPU (plain
     versions), compared;
  5. timings with CUDA events (median of 5 repeats);
  6. a JSON line of the kernels, the card line, and the result line.

It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# published peaks of one H100 SXM at its 700 W limit (dense)
PEAK_BF16 = 989e12          # FLOP/s, tensor cores
PEAK_F32 = 67e12            # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12        # B/s, HBM3

NLAT, NLON, NLEV = 120, 180, 60          # 21,600 columns
LO_NLAT, LO_NLON = 16, 24                # 384 columns
N_STEPS, REPEATS = 20, 5
XSCALE = [250.0, 1e-3, 1e-5, 1e-5, 10.0, 10.0]
YSCALE = [1e-5, 1e-8, 1e-9, 1e-9, 1e-5, 1e-5]
# operations per element of one tracer and level in the FV step: two face
# fluxes (two MC slopes of ~14 operations and ~6 for the upwind value)
# and the update, per sweep
FV_OPS_PER_ELEMENT = 80


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, launches: int, repeats: int = REPEATS,
              queue_ahead: bool = True) -> float:
    """Median over ``repeats`` of the device time per call of ``fn``, from
    CUDA events around ``launches`` calls. With ``queue_ahead`` the card
    first spins for a while so the host queues every call before the
    first runs: the events then time the device alone, not the host's
    launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


# ------------------------------------------------------------ the main path


class ProxyGrid:
    """bench.py's stand-in grid for 21,600 columns: latitude bands with a
    little jitter, unit mass weights, no area weights."""

    def __init__(self, nlat, nlon, nlev, device):
        rng = np.random.default_rng(0)
        ncol = nlat * nlon
        self.lat = np.repeat(np.linspace(-88, 88, nlat), nlon) \
            + rng.uniform(-0.1, 0.1, ncol)
        self.lon = np.tile(np.linspace(0, 360 - 360 / nlon, nlon), nlat)
        self.nlev = nlev
        self.device = device

    def mass_weights(self, ps):
        return torch.ones((ps.shape[0], self.nlev), device=ps.device)

    def layer_thickness(self, ps):
        return torch.full((ps.shape[0], self.nlev), 1e3, device=ps.device)


def make_model(policy, device, seed=0):
    from climsim_tpu_torch.models import RNNAutoreg
    return RNNAutoreg(nx=6, nx_sfc=24, ny=6, ny_sfc=8, nneur=(192, 192),
                      nh_mem=16, add_pres=False, policy=policy,
                      use_pallas=True, fuse_heads=True, fuse_init=True,
                      level_major=True, device=device, seed=seed)


def make_loop(model, grid, nlat, nlon, device):
    """bench.py's production step: normalise -> model -> scale, inside the
    hybrid loop with the fused stencil and both fixers."""
    from climsim_tpu_torch.online import HostLoopConfig, HybridLoop
    dev = next(model.parameters()).device
    xsc = torch.tensor(XSCALE, device=dev)[:, None]
    ysc = torch.tensor(YSCALE, device=dev)[:, None]

    def emulator(x_main_raw, x_sfc_raw, mem):
        out, out_sfc, mem = model(x_main_raw / xsc, x_sfc_raw, mem)
        return out * ysc, out_sfc, mem

    cfg = HostLoopConfig(nlat=nlat, nlon=nlon, scheme="fv",
                         geometry="sphere", use_pallas=True, fix_water=True,
                         fix_energy=True, emulator_level_major=True)
    return HybridLoop(emulator, grid, cfg, device=device)


def initial_state(ncol, nlev, device):
    """bench.py's initial state (np.random.default_rng(1))."""
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    state = {
        "T": t(rng.uniform(220, 300, (ncol, nlev))),
        "qv": t(np.abs(rng.normal(1e-3, 3e-4, (ncol, nlev)))),
        "qc": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
        "qi": t(np.abs(rng.normal(1e-5, 3e-6, (ncol, nlev)))),
        "u": t(rng.normal(0, 10, (ncol, nlev))),
        "v": t(rng.normal(0, 3, (ncol, nlev))),
    }
    mem = torch.zeros((nlev, 16, ncol), device=device)
    x_sfc = torch.cat([torch.full((ncol, 1), 1e5), torch.ones((ncol, 23))],
                      dim=1).to(device)
    return state, mem, x_sfc


# ------------------------------------------------------------ phase 2


def b1_args(model, B, dtype, seed):
    """Random activations at the main path's shapes with the model's
    (lecun-normal) weights, in the layout the fused layer passes."""
    layer = model.bigru_fused
    g = torch.Generator().manual_seed(seed)
    H, L = layer.hidden, NLEV
    dev = next(model.parameters()).device
    r = lambda *s: torch.randn(s, generator=g).to(dev, dtype)
    tw = lambda t: t.detach().to(dtype).t()
    tb = lambda t: t.detach().to(dtype)[:, None]
    CH = layer.init_width
    return (r(L, 6, B), 0.5 * r(L, 16, B), torch.tanh(r(H, B)),
            torch.tanh(r(H, B)), tw(layer.w_init), tb(layer.b_init),
            tw(layer.win1[:CH]), tw(layer.win1[CH:]), tb(layer.bin1),
            tw(layer.whh_up), tb(layer.bhh_up), tw(layer.win2),
            tb(layer.bin2), tw(layer.whh_dn), tb(layer.bhh_dn),
            tw(layer.wlat), tb(layer.blat), tw(layer.wout), tb(layer.bout))


def max_err(a, b) -> float:
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def check_b1(model, card):
    """B1 against its plain version on the card. f32 is held to a tight
    tolerance (summation order only, amplified by the 120 recurrent
    steps); bf16 to 4x the plain version's own bf16-vs-f32 error on the
    same inputs, since a 60-level recurrence magnifies honest rounding
    differences: both outputs are rounded to bf16, so where the plain
    version's own error is the half-ulp rounding of its outputs, a one-ulp
    flip between kernel and plain is already 2x that."""
    from climsim_tpu_torch.ops import (bigru_heads_init_cm_reference as ref,
                                       fused_bigru_heads_init_cm as kern)
    errs = []
    for B in (NLAT * NLON, 1000):
        a32 = b1_args(model, B, torch.float32, seed=B)
        got, want = kern(*a32), ref(*a32)
        e = max_err(got, want)
        scale = max(t.abs().max().item() for t in want)
        print(f"B1 f32 B={B}: max_abs_err {e:.3e} (outputs up to "
              f"{scale:.3f}; tolerance 1e-5 + 1e-5*|x|) [{card}]")
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
        errs.append(e)
        a16 = tuple(t.to(torch.bfloat16) for t in a32)
        got16, want16 = kern(*a16), ref(*a16)
        e16 = max_err(got16, want16)
        own = max_err(want16, ref(*(t.float() for t in a16)))
        print(f"B1 bf16 B={B}: max_abs_err {e16:.3e}, plain bf16-vs-f32 "
              f"{own:.3e}; tolerance 4x that [{card}]")
        check(e16 <= 4.0 * own, f"B1 bf16 B={B}: {e16} > 4 x {own}")
        errs.append(e16)
    return max(errs)


def check_b2(loop, card):
    """B2 against its plain version on the card at (6, 60, 120, 180), with
    winds strong enough to hit the Courant clip in both sweeps. nvcc
    contracts a*b+c into FMAs, so the two differ by a few ulps: tolerance
    1e-5 + 1e-5*|x| on fields of order 1."""
    from climsim_tpu_torch.ops import (fv_advect_tracers_sphere as kern,
                                       fv_tracers_sphere_reference as ref)
    rows = loop.metric_rows
    g = torch.Generator().manual_seed(2)
    dev = loop.device
    qs = (1 + 0.3 * torch.randn((6, NLEV, NLAT, NLON), generator=g)).to(dev)
    u = (60 * torch.randn((NLEV, NLAT, NLON), generator=g)).to(dev)
    v = (100 * torch.randn((NLEV, NLAT, NLON), generator=g)).to(dev)
    cz = (u * rows.dtdx[:, None]).abs() > rows.cfl_max
    cm = (v * rows.cf_fac[:NLAT, None]).abs() > rows.cfl_max
    check(bool(cz.any()) and bool(cm.any()), "the Courant clip never binds")
    got, want = kern(qs, u, v, rows), ref(qs, u, v, rows)
    e = (got - want).abs().max().item()
    print(f"B2 {tuple(qs.shape)}: max_abs_err {e:.3e}; clipped zonal "
          f"{cz.float().mean().item():.3f}, meridional "
          f"{cm.float().mean().item():.3f} of faces [{card}]")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    return e, (qs, u, v, rows)


# ------------------------------------------------------------ phase 4


def compare_384(card):
    """3 coupled steps at 384 columns (Grid.synthetic, 16 x 24) on the card
    and on the CPU, where the wrappers take the plain versions. In f32
    the two agree to summation order: tolerance 1e-5 of each field's
    largest magnitude. In bf16 the card-vs-CPU difference is held to
    4x the CPU's own bf16-vs-f32 difference, field by field (as for B1:
    a one-ulp flip of a bf16 output is 2x its half-ulp rounding)."""
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16, F32
    ncol = LO_NLAT * LO_NLON
    results = {}
    for name, policy in (("f32", F32), ("bf16", BF16)):
        for dev in ("cuda", "cpu"):
            model = make_model(policy, dev)
            grid = Grid.synthetic(ncol, NLEV, device=dev)
            loop = make_loop(model, grid, LO_NLAT, LO_NLON, dev)
            state, mem, x_sfc = initial_state(ncol, NLEV, dev)
            st, mem, diags = loop.rollout(state, mem, x_sfc, 3)
            flat = {**{f"state.{k}": v for k, v in st.items()}, "mem": mem,
                    **{f"diag.{k}": v for k, v in diags.items()}}
            results[name, dev] = {k: v.float().cpu() for k, v in flat.items()}
    worst = 0.0
    for key, want in results["f32", "cpu"].items():
        got = results["f32", "cuda"][key]
        check(bool(torch.isfinite(got).all()), f"384 f32 {key} not finite")
        scale = max(want.abs().max().item(), 1e-30)
        err = (got - want).abs().max().item()
        check(err <= 1e-5 * scale,
              f"384 f32 {key}: card vs CPU {err:.3e} (scale {scale:.3e})")
        worst = max(worst, err / scale)
    print(f"384 columns, 3 steps, f32: card vs CPU worst relative "
          f"difference {worst:.3e} (tolerance 1e-5) [{card}]")
    worst = 0.0
    for key, want in results["bf16", "cpu"].items():
        got = results["bf16", "cuda"][key]
        check(bool(torch.isfinite(got).all()), f"384 bf16 {key} not finite")
        own = (want - results["f32", "cpu"][key]).abs().max().item()
        err = (got - want).abs().max().item()
        tiny = 1e-6 * want.abs().max().item()
        check(err <= 4.0 * own + tiny,
              f"384 bf16 {key}: card vs CPU {err:.3e} > 4 x {own:.3e}")
        worst = max(worst, err / max(own, tiny, 1e-30))
    print(f"384 columns, 3 steps, bf16: card vs CPU difference up to "
          f"{worst:.3f} x the CPU's own bf16-vs-f32 difference "
          f"(tolerance 4x) [{card}]")


# ------------------------------------------------------------ main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from climsim_tpu_torch.ops import (_build, fused_bigru_heads_init_cm,
                                       fv_advect_tracers_sphere,
                                       bigru_heads_init_cm_reference,
                                       fv_tracers_sphere_reference)
    from climsim_tpu_torch import Grid
    from climsim_tpu_torch.models import BF16

    # ---- 1. device and build
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = _build.build_all()
    print(f"kernels built in {build_s:.1f} s (one nvcc per source, in "
          f"parallel)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    ncol = NLAT * NLON
    model = make_model(BF16, None)            # device=None: the card
    loop = make_loop(model, ProxyGrid(NLAT, NLON, NLEV, dev), NLAT, NLON,
                     None)

    # ---- 2. each kernel against its plain version
    b1_err = check_b1(model, card)
    b2_err, b2_inputs = check_b2(loop, card)

    # ---- 3. the main path at 21,600 columns
    state, mem, x_sfc = initial_state(ncol, NLEV, dev)
    fused_bigru_heads_init_cm.launches = 0
    fv_advect_tracers_sphere.launches = 0
    t0 = time.perf_counter()
    st, mem1, diags = loop.rollout(state, mem, x_sfc, N_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"b1": fused_bigru_heads_init_cm.launches,
                "b2": fv_advect_tracers_sphere.launches}
    print(f"main path: {N_STEPS} coupled steps at {ncol} columns in "
          f"{wall:.3f} s (first run); launches {launches} [{card}]")
    check(launches == {"b1": N_STEPS, "b2": N_STEPS},
          f"each kernel must launch {N_STEPS} times, got {launches}")
    for k, v in st.items():
        check(bool(torch.isfinite(v).all()), f"state {k} not finite")
    check(bool(torch.isfinite(mem1).all()), "mem not finite")
    mean_t = diags["mean_T"].cpu()
    check(bool(((mean_t > 150) & (mean_t < 350)).all()),
          f"mean_T out of [150, 350] K: {mean_t.tolist()}")
    check(mem1.shape == (NLEV, 16, ncol) and st["T"].shape == (ncol, NLEV),
          "output shapes")
    print(f"main path: mean_T {mean_t[0].item():.4f} -> "
          f"{mean_t[-1].item():.4f} K, energy_int "
          f"{diags['energy_int'][-1].item():.6e}")

    # ---- 4. the main path at 384 columns, card against CPU
    compare_384(card)

    # ---- 5. timings
    def step_ms(lp, s, m, x):
        return median_ms(lambda: lp.rollout(s, m, x, N_STEPS), 1,
                         queue_ahead=False) / N_STEPS

    hi_ms = step_ms(loop, state, mem, x_sfc)
    lo_ncol = LO_NLAT * LO_NLON
    lo_loop = make_loop(model, Grid.synthetic(lo_ncol, NLEV, device=dev),
                        LO_NLAT, LO_NLON, None)
    lo_state, lo_mem, lo_x = initial_state(lo_ncol, NLEV, dev)
    lo_ms = step_ms(lo_loop, lo_state, lo_mem, lo_x)
    print(f"coupled step, {ncol} columns: {hi_ms:.4f} ms, "
          f"{ncol / hi_ms * 1e3:,.0f} columns/s [{card}]")
    print(f"coupled step, {lo_ncol} columns: {lo_ms:.4f} ms, "
          f"{lo_ncol / lo_ms * 1e3:,.0f} columns/s [{card}]")

    a1 = b1_args(model, ncol, torch.bfloat16, seed=7)
    b1_ms = median_ms(lambda: fused_bigru_heads_init_cm(*a1), 3)
    b1_plain = median_ms(lambda: bigru_heads_init_cm_reference(*a1), 1)
    a1_lo = b1_args(model, lo_ncol, torch.bfloat16, seed=8)
    b1_lo_ms = median_ms(lambda: fused_bigru_heads_init_cm(*a1_lo), 3)
    print(f"B1 bf16 at {lo_ncol} columns: kernel {b1_lo_ms:.4f} ms "
          f"[{card}]")
    qs, u, v, rows = b2_inputs
    b2_ms = median_ms(lambda: fv_advect_tracers_sphere(qs, u, v, rows), 50)
    b2_plain = median_ms(lambda: fv_tracers_sphere_reference(qs, u, v, rows),
                         5)

    # bounds from this run's shapes
    L, nf, B = a1[0].shape
    H, nm_in, nm, ny = a1[9].shape[1], a1[1].shape[1], a1[15].shape[0], \
        a1[17].shape[0]
    macs = H * nf + 3 * H * (H + nm_in) + 3 * 3 * H * H + nm * H + ny * nm
    b1_flops = 2.0 * macs * L * B
    b1_bytes = 2.0 * (sum(t.numel() for t in a1)
                      + L * (nm + ny) * B + H * B)
    b1_bound = max(b1_flops / PEAK_BF16, b1_bytes / PEAK_BYTES) * 1e3
    b1_by = "operations" if b1_flops / PEAK_BF16 > b1_bytes / PEAK_BYTES \
        else "bytes"
    n_el = qs.numel()
    b2_bytes = 4.0 * (2 * n_el + u.numel() + v.numel()
                      + sum(t.numel() for t in rows[:4]))
    b2_flops = float(FV_OPS_PER_ELEMENT * n_el)
    b2_bound = max(b2_flops / PEAK_F32, b2_bytes / PEAK_BYTES) * 1e3
    b2_by = "operations" if b2_flops / PEAK_F32 > b2_bytes / PEAK_BYTES \
        else "bytes"
    print(f"B1 bf16 (L {L}, H {H}, B {B}): kernel {b1_ms:.4f} ms, plain "
          f"{b1_plain:.4f} ms, bound {b1_bound:.4f} ms "
          f"({b1_flops / 1e12:.3f} TFLOP at 989 TFLOP/s; "
          f"{b1_bytes / 1e6:.1f} MB) [{card}]")
    print(f"B2 f32 {tuple(qs.shape)}: kernel {b2_ms:.4f} ms, plain "
          f"{b2_plain:.4f} ms, bound {b2_bound:.4f} ms "
          f"({b2_bytes / 1e6:.1f} MB at 3.35 TB/s) [{card}]")

    # ---- 6. the kernels line, the card line, the result
    kernels = [
        {"name": "bigru_heads_init_cm", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/bigru_heads_init_cm.cu",
         "replaces": "climsim_tpu/ops/pallas_rnn.py:1877",
         "launches": launches["b1"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None},
        {"name": "fv_tracers_sphere", "route": "cuda",
         "source": "climsim_tpu_torch/ops/csrc/fv_tracers_sphere.cu",
         "replaces": "climsim_tpu/ops/pallas_stencil.py:226",
         "launches": launches["b2"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
