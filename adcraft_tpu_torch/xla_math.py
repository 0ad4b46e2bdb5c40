"""XLA's float32 ``log``, ``log1p``, ``erf_inv``, ``sqrt``, ``exp``, ``expm1``,
``tanh``, ``erf`` and ``erfc``, its fused multiply-add and its float scans
on the CPU, operation for operation.

Jitted JAX on the CPU lowers these through LLVM with floating-point
contraction on, so a product whose only use is a sum becomes one fused
multiply-add. The algorithms and constants below are read off the
optimised LLVM IR that XLA emits for them (``--xla_dump_to``), and every
such contraction is written as ``fma32``: Eigen's Cephes ``logf``
(``plog_float``), XLA's ``log1p`` (``log(1 + x)`` outside ``|x| <
sqrt(2) - 1``, a rational function inside) and Giles' ``erf_inv``
polynomial. ``torch.log`` differs from them in the last ulp on 14% of
inputs; these do not, so ``jax.random.normal`` (``prng.normal``) and the
day's binomial and revenue draws equal the JAX package's draw for draw.
``exp`` is XLA's own polynomial (``jax.nn.sigmoid`` is ``1 / (exp(-x) +
1)`` on the CPU), ``erf`` its rational function, and ``erfc`` the
expansion JAX's ``chlo.erfc`` lowers to; together they give ``ndtr`` and
the normal pdf of the revenue and explicit cost moments. The CUDA kernels
spell the same operations (``csrc/xla_math.cuh``), so on the card they
equal these functions exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _fma32_odd(a, b, c) -> torch.Tensor:
    """``fma32`` by float64: the product of two float32 values is exact in
    float64, so only the float64 sum rounds before the cast to float32,
    which then rounds again. That changes the result only where the sum
    lies on a float32 midpoint, and there the sum is rounded to odd first:
    where it is inexact (its TwoSum error is not 0) and its last bit is
    even, it steps to its neighbour on the error's side. A float64 rounded
    to odd has more than two bits beyond float32's, so the cast then rounds
    correctly. The rounding to odd runs only when some sum's low 28 bits
    are 0 (every midpoint's are, normal or subnormal)."""

    def f64(x):  # a Python number is the float32 constant XLA computes with
        return x.double() if isinstance(x, torch.Tensor) else float(np.float32(x))

    p, c = f64(a) * f64(b), f64(c)
    s = p + c
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, dtype=torch.float64)
    bits = s.view(torch.int64)
    if not bool(((bits & 0xFFFFFFF) == 0).any()):
        return s.float()
    back = s - p
    err = (p - (s - back)) + (c - back)
    step = (err != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    away = (err > 0) == (s > 0)  # the neighbour of larger magnitude
    bits = bits + torch.where(step, torch.where(away, 1, -1), 0)
    return bits.view(torch.float64).float()


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), as XLA's
    contractions and CUDA's ``__fmaf_rn`` round it. On the card, torch's
    float32 ``addcmul``, which rounds once there (``tests/test_torch_cuda.py``
    holds it to ``_fma32_odd`` on halfway triples); on the CPU,
    ``_fma32_odd``'s float64 rounded to odd. Python numbers stay scalars or
    become fills (no host-to-device copy)."""
    like = next((x for x in (a, b, c) if isinstance(x, torch.Tensor)), None)
    if like is not None and like.is_cuda:
        a, b, c = (torch.full_like(like, x, dtype=torch.float32)
                   if not isinstance(x, torch.Tensor)
                   else x if x.is_floating_point() else x.float() for x in (a, b, c))
        if not all(x.dtype == torch.float32 for x in (a, b, c)):
            raise TypeError("fma32 takes float32 (or integer) tensors")
        return torch.addcmul(c, a, b)
    return _fma32_odd(a, b, c)


_SCAN_BLOCK = 16


def _scan(x: torch.Tensor, dim: int, mul: bool) -> torch.Tensor:
    """XLA's CPU float scan along ``dim``: blocks of 16 scanned in order,
    the blocks' totals scanned the same way (recursively), and each block
    after the first combined with the total of the blocks before it.
    Products flush subnormal results to zero, as XLA's CPU code does."""
    op = (lambda a, b: ftz(a * b)) if mul else torch.add
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _SCAN_BLOCK:
        out = [x[0]] if n else []
        for i in range(1, n):
            out.append(op(out[-1], x[i]))
        return (torch.stack(out) if n else x).movedim(0, dim)
    pad = -n % _SCAN_BLOCK
    fill = x.new_ones if mul else x.new_zeros
    blocks = torch.cat([x, fill((pad,) + tuple(x.shape[1:]))]).unflatten(0, (-1, _SCAN_BLOCK))
    within = _scan(blocks, 1, mul)
    carry = _scan(within[:, -1], 0, mul)
    out = torch.cat([within[:1], op(within[1:], carry[:-1].unsqueeze(1))])
    return out.flatten(0, 1)[:n].movedim(0, dim)


def cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.cumsum`` of a float tensor as jitted XLA adds it on the CPU:
    not in sequence but in blocks of 16 (``_scan``)."""
    return _scan(x, dim, mul=False)


def cumprod(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.cumprod`` of a float tensor in XLA's CPU order (``_scan``)."""
    return _scan(x, dim, mul=True)


_SUM_WINDOW = 32


def sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.sum`` of a float tensor along ``dim`` as jitted XLA adds it on
    the CPU: up to 32 elements in sequence; more in windows of 32 (the
    zero padding split evenly before and after), each window in sequence,
    then the windows' sums the same way."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n > _SUM_WINDOW:
        w = -(-n // _SUM_WINDOW)
        pad = w * _SUM_WINDOW - n
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        return sum(sum(x.unflatten(-1, (w, _SUM_WINDOW)), -1), -1)
    out = x[..., 0] if n else x.new_zeros(x.shape[:-1])
    for i in range(1, n):
        out = out + x[..., i]
    return out


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's (and CUDA's
    ``sqrtf``): torch's own on the CPU is not, on about 0.7% of inputs. The
    float64 root rounds to the same float32."""
    return torch.sqrt(x.double()).float()


@functools.lru_cache(maxsize=None)
def table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A table of constants on ``device``, built once: ``torch.tensor`` on
    a CUDA device is a blocking copy."""
    return torch.tensor(values, dtype=dtype, device=device)


def _f64(hexes: str) -> tuple:
    return tuple(float.fromhex(h) for h in hexes.split())


# the C library's powf (its double-precision log2 and exp2): 16 (1/c,
# log2(c)) pairs, the log2 polynomial, 32 entries 2**(i/32) less i << 47
# (bit patterns) and the exp2 polynomial
_POW_INVC = _f64("""0x1.661ec79f8f3bep+0 0x1.571ed4aaf883dp+0 0x1.49539f0f010b0p+0
    0x1.3c995b0b80385p+0 0x1.30d190c8864a5p+0 0x1.25e227b0b8ea0p+0 0x1.1bb4a4a1a343fp+0
    0x1.12358f08ae5bap+0 0x1.0953f419900a7p+0 0x1p+0 0x1.e608cfd9a47acp-1 0x1.ca4b31f026aa0p-1
    0x1.b2036576afce6p-1 0x1.9c2d163a1aa2dp-1 0x1.886e6037841edp-1 0x1.767dcf5534862p-1""")
_POW_LOGC = _f64("""-0x1.efec65b963019p-2 -0x1.b0b6832d4fca4p-2 -0x1.7418b0a1fb77bp-2
    -0x1.39de91a6dcf7bp-2 -0x1.01d9bf3f2b631p-2 -0x1.97c1d1b3b7af0p-3 -0x1.2f9e393af3c9fp-3
    -0x1.960cbbf788d5cp-4 -0x1.a6f9db6475fcep-5 0x0p+0 0x1.338ca9f24f53dp-4 0x1.476a9543891bap-3
    0x1.e840b4ac4e4d2p-3 0x1.40645f0c6651cp-2 0x1.88e9c2c1b9ff8p-2 0x1.ce0a44eb17bccp-2""")
_POW_A = _f64("""0x1.27616c9496e0bp-2 -0x1.71969a075c67ap-2 0x1.ec70a6ca7baddp-2
    -0x1.7154748bef6c8p-1 0x1.71547652ab82bp+0""")
_EXP2_T = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F, 0x3FEF9301D0125B51,
    0x3FEF72B83C7D517B, 0x3FEF54873168B9AA, 0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1,
    0x3FEF06FE0A31B715, 0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429, 0x3FEEA47EB03A5585,
    0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74, 0x3FEEA11473EB0187, 0x3FEEA589994CCE13,
    0x3FEEACE5422AA0DB, 0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C, 0x3FEF3720DCEF9069,
    0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F, 0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2_C = _f64("0x1.c6af84b912394p-5 0x1.ebfce50fac4f3p-3 0x1.62e42ff0c52d6p-1")
_EXP2_SHIFT = float.fromhex("0x1.8p+47")
_EXP2_SHIFT_BITS = 0x42E8000000000000


def pow(x: torch.Tensor, y) -> torch.Tensor:
    """float32 ``x ** y`` for normal ``x > 0`` or 0 (or ``y`` 0, or ``x`` 1) as
    XLA's CPU code computes it: by the C library's ``powf``, whose log2
    and exp2 run in float64 on tables (read off glibc's); a result below
    float32's normal range is flushed to zero, as XLA's CPU code runs."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device).double()
    ix = x.view(torch.int32)
    tmp = ix - 0x3F330000
    i = ((tmp >> 19) & 15).to(torch.int64)
    top = tmp & -0x800000
    z = (ix - top).view(torch.float32).double()
    k = (top >> 23).double()
    r = z * table(_POW_INVC, torch.float64, x.device)[i] - 1.0
    y0 = table(_POW_LOGC, torch.float64, x.device)[i] + k
    a = _POW_A
    r2 = r * r
    log2x = (a[0] * r + a[1]) * (r2 * r2) + ((a[2] * r + a[3]) * r2 + (a[4] * r + y0))
    ylogx = y * log2x
    kd = ylogx + _EXP2_SHIFT
    ki = kd.view(torch.int64)
    kd = kd - _EXP2_SHIFT
    r = ylogx - kd
    t = table(_EXP2_T, torch.int64, x.device)[ki & 31]
    s = (t + ((ki - _EXP2_SHIFT_BITS) << 47)).view(torch.float64)
    c = _EXP2_C
    out = ((c[0] * r + c[1]) * (r * r) + (c[2] * r + 1.0)) * s
    out = torch.where(ylogx <= -150.0, 0.0, out).float()
    out = torch.where(x == 0.0, 0.0, ftz(out))  # 0 ** y, y > 0
    return torch.where((y == 0) | (x == 1.0), 1.0, out)


def f32(bits: int) -> float:
    """The float32 whose bit pattern is ``bits``."""
    return float(np.array(bits, np.uint32).view(np.float32))


# Cephes logf: the (mantissa - 1) polynomial in three interleaved chains
_LOG_P = tuple(f32(b) for b in (0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC,
                                0xBE7FFFFC, 0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA))
_LOG_Q1 = f32(0xB95E8083)  # -2.12194440e-4, the low part of log(2)
_LOG_Q2 = f32(0x3F318000)  # 0.693359375, the high part
_SQRT_HALF = f32(0x3F3504F3)
_FLT_MIN = f32(0x00800000)
# log1p's rational function on |x| < sqrt(2) - 1: numerator and denominator
# coefficients, highest power first (the denominator's leading one is 1)
_LOG1P_NUM = tuple(f32(b) for b in (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76,
                                    0x426473AD, 0x41A05101))
_LOG1P_DEN = tuple(f32(b) for b in (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A,
                                    0x42707982))
_LOG1P_SMALL = f32(0x3ED413CD)  # sqrt(2) - 1
# erf_inv: Giles' polynomials in w - 2.5 (w < 5) and sqrt(w) - 3
_ERFINV_LT5 = tuple(f32(b) for b in (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB,
                                     0xBAA45408, 0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F))
_ERFINV_GE5 = tuple(f32(b) for b in (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B,
                                     0xBBF9C5D7, 0x3C1AA57E, 0x3F8036DB, 0x40354F7E))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 natural log: ``e ln 2 + log(m)`` for ``y = m 2**e``
    with m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial in ``m - 1``.
    XLA's CPU code treats subnormal inputs as 0 (-inf); inf gives inf, and
    a negative or NaN input NaN."""
    bits = torch.where(y > _FLT_MIN, y, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = mant < _SQRT_HALF
    x = (mant - 1.0) + torch.where(low, mant, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    z = x * x
    x3 = z * x
    c = _LOG_P
    p0 = fma32(fma32(x, c[0], c[1]), x, c[6])
    p1 = fma32(fma32(x, c[2], c[3]), x, c[7])
    p2 = fma32(fma32(x, c[4], c[5]), x, c[8])
    poly = fma32(fma32(p0, x3, p1), x3, p2)
    out = fma32(poly, x3, e * _LOG_Q1) + fma32(z, -0.5, x)
    out = fma32(e, _LOG_Q2, out)
    out = torch.where(torch.isnan(y) | (y < 0), float("nan"), out)
    out = torch.where(y == float("inf"), float("inf"), out)
    return torch.where(torch.abs(y) < _FLT_MIN, float("-inf"), out)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: ``log(1 + x)`` for ``|x| >= sqrt(2) - 1``,
    else ``x - x**2/2 + x**3 P(x)/Q(x)``."""
    num = torch.full_like(x, _LOG1P_NUM[0])
    for coef in _LOG1P_NUM[1:]:
        num = fma32(num, x, coef)
    den = torch.ones_like(x)
    for coef in _LOG1P_DEN:
        den = fma32(den, x, coef)
    x2 = x * x
    small = x + fma32(x2, -0.5, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < _LOG1P_SMALL, small, log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: Giles' polynomial in ``w = -log1p(-x**2)``
    (``w - 2.5`` below 5, ``sqrt(w) - 3`` above) by fused Horner steps,
    times x; +-1 give +-inf."""
    l1p = log1p(x * -x)
    lt = l1p > -5.0
    w = torch.where(lt, -2.5 - l1p, sqrt(-l1p) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lt_coef, ge_coef in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, torch.where(lt, lt_coef, ge_coef))
    return x * torch.where(torch.abs(x) == 1.0, float("inf"), p)


# exp: Cephes expf as XLA's CPU backend emits it: x clamped to the float
# range, n = floor(x log2(e) + 1/2) in [-127, 127], r = x - n ln 2 in two
# parts, a degree-5 polynomial, and the scale 2**n built in the exponent
# bits (2**-127 is 0)
_EXP_LO, _EXP_HI = f32(0xC2AF999A), f32(0x42B1999A)
_LOG2E = f32(0x3FB8AA3B)
_EXP_C1, _EXP_C2 = f32(0x3F318000), f32(0xB95E8083)
_EXP_P = tuple(f32(b) for b in (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA))
# erf: x clamped to +-3.7439, x P(x**2) / Q(x**2)
_ERF_CLAMP = f32(0x406F9C68)
_ERF_P = tuple(f32(b) for b in (0x39702D51, 0x3B5F5DA2, 0x3D50B6EB, 0x3E3DA740, 0x3F906EBA))
_ERF_Q = tuple(f32(b) for b in (0xB3FD3906, 0x37C588DF, 0x3A856D28, 0x3C6687D4, 0x3DE34C21,
                                0x3EFEB44A))
# erfc: 1 - x P(x**2) below 1, else exp(-x**2) / x times a polynomial in
# 1/x**2 (one below 2, one above), 0 past x**2 = 88.72
_ERFC_SMALL = tuple(np.float32(c).item() for c in (
    7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129, 0.112835854, -0.37612626,
    1.12837911))
_ERFC_LT2 = tuple(np.float32(c).item() for c in (
    0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469, -0.494451523, 0.340488,
    -0.274112701, 0.563825965))
_ERFC_GE2 = tuple(np.float32(c).item() for c in (
    -10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523, 0.42184633, -0.282076746,
    0.564189494))
_ERFC_UNDERFLOW = f32(0x42B17218)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal results to zero: XLA's CPU code runs with flush-to-zero."""
    return torch.where(torch.abs(x) < _FLT_MIN, 0.0, x)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...`` by fused steps."""
    p = fma32(x, coefs[0], coefs[1])
    for c in coefs[2:]:
        p = fma32(p, x, c)
    return p


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``exp`` on the CPU."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma32(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma32(n, -_EXP_C1, x)
    r = fma32(n, -_EXP_C2, r)
    y = fma32(_horner(r, _EXP_P), r, 0.5)
    y = fma32(y, r * r, r) + 1.0
    return ftz(y * ((n.to(torch.int32) + 127) << 23).view(torch.float32))


# tanh: x clamped to +-7.998, x P(x**2) / Q(x**2); x itself below 4e-4,
# +-1 from 20 on
_TANH_CLAMP, _TANH_SMALL = f32(0x40FFF644), f32(0x39D1B717)
_TANH_P = tuple(f32(b) for b in (0xA59F25C0, 0x2A61337E, 0xAEBD37FF, 0x335C0041, 0x3779434A,
                                 0x3A270DED, 0x3BA059DC))
_TANH_Q = tuple(f32(b) for b in (0x35A0D3D8, 0x38F895D6, 0x3B14AA05, 0x3BA059DD))


def tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``tanh`` on the CPU (its rational approximation)."""
    xc = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    x2 = xc * xc
    out = (xc * _horner(x2, _TANH_P)) / _horner(x2, _TANH_Q)
    out = torch.where(torch.abs(x) < _TANH_SMALL, x, out)
    return torch.where(torch.abs(x) >= 20.0, torch.copysign(torch.ones_like(x), x), out)


def expm1(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``expm1`` on the CPU: ``exp(x) - 1`` where ``|x| >
    1/2``, else ``tanh(x / 2) (exp(x) + 1)``, and x where ``x / 2`` is 0."""
    e = exp(x)
    half = x * 0.5
    out = torch.where(torch.abs(x) > 0.5, e - 1.0, tanh(half) * (e + 1.0))
    return torch.where(half == 0, x, out)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` (XLA's ``logistic``) on the CPU: ``1 / (exp(-x) +
    1)``."""
    return ftz(1.0 / (exp(-x) + 1.0))


def erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf`` on the CPU."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    return (x * _horner(x2, _ERF_P)) / fma32(_horner(x2, _ERF_Q), x2, 1.0)


def erfc(x: torch.Tensor) -> torch.Tensor:
    """JAX's float32 ``erfc`` as XLA computes it on the CPU."""
    z = torch.abs(x)
    x2 = x * x
    small = fma32(-x, _horner(x2, _ERFC_SMALL), 1.0)
    q = 1.0 / x2
    tail = torch.where(z < 2.0, _horner(q, _ERFC_LT2), _horner(q, _ERFC_GE2))
    large = ftz((exp(-x2) * (1.0 / z)) * tail)
    large = torch.where(x2 > _ERFC_UNDERFLOW, 0.0, large)
    large = torch.where(x < 0, 2.0 - large, large)
    return torch.where(z < 1.0, small, large)
