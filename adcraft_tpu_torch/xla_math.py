"""XLA's float32 ``log``, ``log1p``, ``erf_inv``, ``sqrt``, ``exp``, ``erf``
and ``erfc`` on the CPU, operation for operation.

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

import numpy as np
import torch


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add).

    The product of two float32 values is exact in float64, so only the sum
    rounds twice, which changes the float32 result for about one input in
    2**29. The CUDA kernels compute the same float64 operations. Python
    numbers stay scalars (no host-to-device copy).
    """

    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (f64(a) * f64(b) + f64(c)).float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded as XLA's (and CUDA's
    ``sqrtf``): torch's own on the CPU is not, on about 0.7% of inputs. The
    float64 root rounds to the same float32."""
    return torch.sqrt(x.double()).float()


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
