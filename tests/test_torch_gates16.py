"""The three premises of the bf16-gate step's design (ops/csrc/gates16.cuh),
checked on the CPU with numpy over every bf16 value they concern:

(a) a reciprocal within 1 float32 ulp of 1/d rounds to the bf16 of the
    exact 1/d for every finite bf16 d >= 1: the flushing MUFU.RCP
    wherever the common path can meet d, the form that keeps subnormal
    quotients (rcp.approx.f32) beyond, where only the rare path goes;
(b) the tie rule sends every input whose exponential's bf16 could differ
    from expf's to expf: the SFU's result may lie anywhere within its
    error bound of exp(-S x), expf's anywhere within 2 ulps;
(c) a packed bf16 sum, difference or product, rounded once from the exact
    result, is the bf16 that float32 arithmetic followed by a rounding
    gives.

The card checks (tests/test_torch_cuda.py, chip_smoke.py phase 16) then
hold the step itself against the accurate forms it replaced on all 65,536
bf16 inputs and on seeded operand sets.
"""
import numpy as np
import pytest
import torch

# the SFU exponential's bound in float32 ulps (ex2.approx: 2 ulps from the
# rounded result) and the rounded argument's (1.223 S |x|, from the
# float32 product x * -S log2(e)); expf's bound (2 ulps)
EX2_ULPS, ARG_ULPS, EXPF_ULPS = 2.5, 1.223, 2.0
# the tie rule: within 6 + 1.25 S |x| ulps of a bf16 midpoint
TIE_BASE, TIE_SLOPE = 6.0, 1.25


def all_bf16() -> np.ndarray:
    """Every finite bf16 value, as float64."""
    v = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)].astype(np.float64)


def round_bf16(v) -> np.ndarray:
    """float64 values rounded to bf16 (nearest, ties to even; bf16 shares
    float32's exponent range, so its subnormals are 2^-133 apart), as
    float64: the correctly rounded bf16 of the value."""
    v = np.asarray(v, dtype=np.float64)
    out = v.copy()
    fin = np.isfinite(v) & (v != 0)
    _, e = np.frexp(v[fin])
    step = np.ldexp(1.0, np.maximum(e - 8, -133))
    q = np.round(v[fin] / step) * step
    out[fin] = np.where(np.abs(q) >= 2.0 ** 128, np.copysign(np.inf, q), q)
    return out


def r16_f32(y) -> np.ndarray:
    """float32 values rounded to bf16 as __float2bfloat16_rn and torch do
    (the carry into the upper half), as float64; finite inputs."""
    u = np.asarray(y, dtype=np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32).astype(np.float64)


def f32_ulp(v) -> np.ndarray:
    """The float32 spacing at |v| (2^-149 among the subnormals)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, np.maximum(e - 24, -149))


def band(v, ulps):
    """The float32 values within ``ulps`` (per element) float32 ulps of
    v > 0: for each bit offset from float32(v), the values there and
    whether each lies inside the band."""
    u0 = v.astype(np.float32).view(np.uint32).astype(np.int64)
    reach = np.abs(ulps * f32_ulp(v))
    kmax = int(np.ceil(np.max(ulps))) + 2
    for k in range(-kmax, kmax + 1):
        y = (u0 + k).astype(np.uint32).view(np.float32).astype(np.float64)
        yield y, np.abs(y - v) <= reach


def same(a, b) -> np.ndarray:
    """Equal as bf16 values, the sign of a zero included."""
    return (a == b) & (np.signbit(a) == np.signbit(b))


def test_rounding_helpers_match_torch():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(np.uint32)
    y = u.view(np.float32)
    y = y[np.isfinite(y)]
    want = torch.from_numpy(y.copy()).to(torch.bfloat16).float().numpy()
    fin = np.isfinite(want)
    assert np.array_equal(r16_f32(y)[fin], want[fin].astype(np.float64))
    # a float32 is exact in float64: rounding it from there is the same
    assert np.array_equal(round_bf16(y[fin]), want[fin].astype(np.float64))


def test_reciprocal_rounds_as_ieee_division():
    d = all_bf16()
    d = d[d >= 1.0]
    exact = 1.0 / d          # float64: far inside every margin below
    want = round_bf16(exact)
    # the distance of 1/d from the nearest bf16 midpoint (the odd
    # multiples of half the bf16 spacing), in float32 ulps, where 1/d is a
    # normal float32 and d not a power of 2
    _, e = np.frexp(exact)
    half = np.ldexp(1.0, np.maximum(e - 9, -134))
    t = exact / half
    r = t - (np.floor((t - 1) / 2) * 2 + 1)
    margin = np.minimum(r, 2 - r) * half / f32_ulp(exact)
    pow2 = np.frexp(d)[0] == 0.5
    normal = exact >= 2.0 ** -126
    assert margin[~pow2 & normal].min() >= 128.5 - 1e-6
    # the largest d of the common path: x >= -87 / S there, so e at most
    # e^87 (and the SFU's error), 1 + e rounded twice
    top = round_bf16(1.0 + round_bf16(np.exp(87.0) * (1 + 2.0 ** -20)))
    assert top < 2.0 ** 126
    common = d <= top
    checked = 0
    for y, inside in band(exact, np.ones_like(exact)):
        # a flushing reciprocal gives 0 for a subnormal quotient
        flushed = np.where(y < 2.0 ** -126, 0.0, y)
        kernel = np.where(common, flushed, y)
        assert same(r16_f32(kernel[inside]), want[inside]).all()
        checked += int(inside.sum())
    assert checked >= 2 * d.size       # the float32s on both sides of 1/d
    # past the common path, the quotients of d > 2^126 are float32
    # subnormals that bf16 holds, and a flushing reciprocal would lose them
    sub = exact < 2.0 ** -126
    assert sub.sum() > 0 and (want[sub] > 0).all() and not common[sub].any()
    assert not same(np.zeros(int(sub.sum())), want[sub]).any()


def near_tie(x, y, S) -> np.ndarray:
    """gates16.cuh's near_tie: the low 16 bits of y less 0x8000 against
    fmaf(|x|, 1.25 S, 6) in float32."""
    low = (y.astype(np.float32).view(np.uint32) & 0xFFFF).astype(np.float64)
    limit = (np.abs(x) * (TIE_SLOPE * S) + TIE_BASE).astype(np.float32)
    return np.abs(low - 0x8000) <= limit


@pytest.mark.parametrize("S", [1, 2])
def test_tie_rule_sends_every_doubtful_input_to_expf(S):
    x = all_bf16()
    with np.errstate(over="ignore"):
        v = np.exp(-S * x)
    x, v = x[(v >= 2.0 ** -126) & (v < 2.0 ** 128)], \
        v[(v >= 2.0 ** -126) & (v < 2.0 ** 128)]
    # the bf16s expf may round to: one, or two where v is within expf's
    # error of a midpoint; then the rule must send every SFU result
    lo = np.full_like(v, np.inf)
    hi = np.full_like(v, -np.inf)
    for w, inside in band(v, np.full_like(v, EXPF_ULPS)):
        r = np.where(inside, r16_f32(w), np.nan)
        lo, hi = np.fmin(lo, r), np.fmax(hi, r)
    doubtful = lo != hi
    bound = EX2_ULPS + ARG_ULPS * S * np.abs(x)
    sent = np.zeros_like(v, dtype=bool)
    for y, inside in band(v, bound):
        fast = inside & ~near_tie(x, y, S)
        # an SFU result the rule keeps rounds to expf's one bf16
        assert not (fast & doubtful).any()
        assert (r16_f32(y)[fast] == lo[fast]).all()
        sent |= inside & ~fast
    # the rule has work to do, and sends few inputs: the SFU result nearest
    # the exact value is sent for a few inputs in 10^4 (the card counts the
    # SFU's own)
    assert doubtful.sum() > 0
    share = near_tie(x, v.astype(np.float32).astype(np.float64), S).mean()
    assert 0 < share < 2e-3, share


def _pairs(rng, n):
    """Seeded bf16 operand pairs (a, b): random bit patterns (finite),
    values of order 1 at exponent gaps 0-30, subnormals, 1 +- tiny, and
    every pair of signed zeros, +-1, the extreme subnormal, the least
    normal, 1 + 2^-7 and 1 - 2^-8."""
    parts = []
    with np.errstate(invalid="ignore"):
        a, b = (rng.integers(0, 65536, (2, n), dtype=np.uint32)
                << 16).view(np.float32).astype(np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    parts.append((a[ok], b[ok]))
    m = round_bf16(rng.uniform(1, 2, (2, n)) * rng.choice([-1, 1], (2, n)))
    parts.append((m[0], m[1] * np.ldexp(1.0, -rng.integers(0, 31, n))))
    parts.append(tuple(round_bf16(rng.uniform(-1, 1, (2, n))
                                  * 2.0 ** -126)))
    tiny = np.ldexp(1.0, -rng.integers(8, 140, n))
    parts.append((np.ones(n), round_bf16(rng.choice([-1, 1], n) * tiny)))
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.0 ** -133, -2.0 ** -133,
                     2.0 ** -126, 1.0 + 2.0 ** -7, 1.0 - 2.0 ** -8])
    e1, e2 = np.meshgrid(edge, edge)
    parts.append((e1.ravel(), e2.ravel()))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_packed_ops_round_as_f32_then_bf16(op):
    rng = np.random.default_rng({"add": 1, "sub": 2, "mul": 3}[op])
    a, b = _pairs(rng, 200_000)
    a, b = np.concatenate([a, b]), np.concatenate([b, a])
    f = {"add": np.add, "sub": np.subtract, "mul": np.multiply}[op]
    with np.errstate(over="ignore", invalid="ignore"):
        packed = round_bf16(f(a, b))        # the exact result, rounded once
        f32 = f(a.astype(np.float32), b.astype(np.float32))
    fin = np.isfinite(f32)
    via_f32 = np.full_like(packed, np.nan)
    via_f32[fin] = r16_f32(f32[fin])
    via_f32[~fin] = f32[~fin]
    assert same(packed, via_f32).all(), (
        a[~same(packed, via_f32)][:5], b[~same(packed, via_f32)][:5])
