"""Stateless, key-driven distribution helpers (the day step's subset).

Counterparts of ``adcraft_tpu/distributions.py``: ``probify`` (:27),
``nonnegify`` (:32), ``round_cents`` (:53), the budget's cents as both
day routes cast them (``cents_int32``), ``nonneg_int_normal`` (:67),
``binomial`` (:84, ``jax.random.binomial``'s two loops in lockstep over
each call), ``rev_normal_cents`` (:246), and the XLA day step's samplers
and moments: ``binomial_inv`` (:102),
``binomial_cdf`` (:192), ``binomial_inv_from_cdf`` (:230), ``uniform16``
(:358), ``censored_normal_moments`` (:387), ``rev_sum_cents`` (:519),
``single_cost_cent_moments_closed`` (:589), ``agg_cost_cents`` (:704,
32-bit draws, with the pool's ``cmin``), the binomial pool's
``pool_cost_deci_moments`` (:746, its table ``max_bidders_bound`` columns
wide) and ``pool_cost_lane_draws`` (:847), ``laplace_cdf`` (:874),
``laplace_icdf`` (:880) and ``truncated_laplace`` (:888), and the
oracle's competitor bids ``abs_laplace_cents`` (:258). ``torch.round`` rounds half to even, as
``jnp.round`` does.

Float arithmetic follows what jitted XLA computes on the CPU, where that
is not what the source spells: XLA divides by a constant as a product
with its float32 reciprocal (``_recip``), and contracts ``c + a * b``
into a fused multiply-add in ``laplace_icdf``, ``truncated_laplace``,
``agg_cost_cents``, ``rev_sum_cents`` and the censored and clipped normal
moments (``fma32``). The transcendentals are XLA's own (``xla_math``):
``exp``, ``expm1``, ``log``, ``erf`` and ``erfc`` read off its CPU code,
``pow`` the C library's ``powf`` it calls, and its float scans in blocks of
16 (the ladder's ``cumprod`` and ``cumsum``); so the Laplace draws, the
win probability, the ladder, the revenue and explicit cost moments and
the implicit cost moments' mean equal jitted XLA's bit for bit (the
implicit std on all but about 0.1% of cells). The inverse-CDF walk's
``pow`` is still torch's.
Every per-cell function here is also what the CUDA kernels of
``agg_day`` compute, operation for operation, so the kernels and these
functions agree exactly on the card.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from adcraft_tpu_torch import prng, xla_math
from adcraft_tpu_torch.xla_math import fma32

_INV_65536 = 1.0 / 65536.0
_INV_SQRT2 = float(np.float32(1.0 / math.sqrt(2.0)))


def recip(x: float) -> float:
    """The float32 reciprocal of a constant, as XLA folds ``a / c``."""
    return float(np.float32(1.0) / np.float32(x))


def bits_to_uniform(bits: torch.Tensor, bit_width: int) -> torch.Tensor:
    """Threefry words to float32 uniforms: ``jax.random.uniform``'s
    mantissa transform for 32-bit words, ``uniform16``'s midpoint mapping
    ``(b + 0.5) / 65536`` for 16-bit ones."""
    if bit_width == 16:
        return (bits.to(torch.float32) + 0.5) * _INV_65536
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform16(key: torch.Tensor, shape) -> torch.Tensor:
    """Uniforms in (0, 1) from 16-bit draws, ``(bits + 0.5) / 65536``.

    The draw is the low half of the 32-bit word at the same counter
    (``prng.random_bits``), not two draws per word.
    """
    return bits_to_uniform(prng.random_bits(key, shape, 16), 16)


def lane_uniform(key: torch.Tensor, shape, bits: int) -> torch.Tensor:
    """``uniform16`` at ``bits=16``, else ``jax.random.uniform``."""
    return uniform16(key, shape) if bits == 16 else prng.uniform(key, shape)


def laplace_cdf(x, loc, scale) -> torch.Tensor:
    """CDF of Laplace(loc, scale)."""
    return _laplace_cdf_z((x - loc) / scale)


def _laplace_cdf_z(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z < 0, 0.5 * xla_math.exp(z), 1.0 - 0.5 * xla_math.exp(-z))


def bid_cdf(bid, loc, scale, cent_bids: bool = False) -> torch.Tensor:
    """``laplace_cdf(bid, loc, scale)``. With ``cent_bids`` the bid is the
    env's ``round_cents`` output, ``round(100 b) * 0.01``: in the env's
    program jitted XLA contracts that product into the CDF's ``bid - loc``
    (one fused multiply-add of the cents), which this follows."""
    if not cent_bids:
        return laplace_cdf(bid, loc, scale)
    return _laplace_cdf_z(fma32(torch.round(bid * 100.0), recip(100.0), -loc) / scale)


def laplace_icdf(u: torch.Tensor, loc, scale) -> torch.Tensor:
    """Inverse CDF of Laplace(loc, scale); logs clamped away from 0."""
    lo = xla_math.log(torch.clamp(2.0 * u, min=1e-38))
    hi = -xla_math.log(torch.clamp(2.0 * (1.0 - u), min=1e-38))
    return fma32(scale, torch.where(u < 0.5, lo, hi), loc)


def laplace(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.laplace``: ``sign(u) * log1p(-|u|)`` of a uniform on
    [nextafter(-1, 0), 1), XLA's ``log1p``."""
    u = prng.uniform_open(key, shape)
    return torch.sign(u) * xla_math.log1p(-u.abs())


def abs_laplace_cents(key: torch.Tensor, loc, scale, shape, lowest_bid: float = 0.0
                      ) -> torch.Tensor:
    """``round(max(|loc + scale * Laplace|, lowest_bid), 2)`` draws: the
    floor applies before the cent rounding, as in the reference."""
    draw = loc + scale * laplace(key, shape)
    return round_cents(torch.clamp(draw.abs(), min=lowest_bid))


def truncated_laplace(key, loc, scale, low, high, shape, bits: int = 32) -> torch.Tensor:
    """Inverse-CDF draws of Laplace(loc, scale) truncated to [low, high]."""
    f_lo = laplace_cdf(low, loc, scale)
    f_hi = laplace_cdf(high, loc, scale)
    u = lane_uniform(key, shape, bits)
    return laplace_icdf(fma32(u, f_hi - f_lo, f_lo), loc, scale)


_F32 = np.float32
# jax.random's Stirling-tail table (jax/_src/random.py:_stirling_approx_tail)
_STIRLING_TAIL = (
    0.0810614667953272, 0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
    0.0166446911898211, 0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
    0.00925546218271273, 0.00833056343336287,
)


def _c(x: float) -> float:
    """A Python constant as the float32 value jnp rounds it to."""
    return float(_F32(x))


def _stirling_approx_tail(k: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s Stirling remainder: the table for k <= 9, else the
    series ``(1/12 - (1/360 - 1/1260/(k+1)^2)/(k+1)^2)/(k+1)``."""
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1.0) * (k + 1.0)
    approx = (_c(1.0 / 12) - (_c(1.0 / 360) - _c(1.0 / 1260) / kp1sq) / kp1sq) / (k + 1.0)
    tail = xla_math.table(_STIRLING_TAIL, torch.float32, k.device)
    return torch.where(use_table, tail[torch.floor(k).to(torch.int64)], approx)


def _rows_where(live: torch.Tensor) -> torch.Tensor:
    return live.nonzero().squeeze(1)


def _binomial_inversion(keys: torch.Tensor, count: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s geometric-sum inversion for a batch of calls: keys
    (C, 2), count and q (C, K). A call's loop runs while any of its K
    elements has ``geom_sum <= count``; a finished call's carry is frozen
    (``vmap``'s batched ``while_loop``). Each pass: ``subkey, key =
    split(key)``, one uniform per element."""
    K = count.shape[1]
    log1mq = xla_math.log1p(-q)
    num_geom = torch.zeros_like(q)
    geom_sum = torch.zeros_like(q)
    key = keys.clone()
    while True:
        rows = _rows_where((geom_sum <= count).any(1))
        if rows.numel() == 0:
            return num_geom - 1.0
        subkey, key[rows] = prng.split(key[rows]).unbind(-2)
        g = geom_sum[rows]
        num_geom[rows] = torch.where(g <= count[rows], num_geom[rows] + 1.0, num_geom[rows])
        u = prng.uniform(subkey, (K,))
        geom_sum[rows] = g + torch.ceil(xla_math.log(u) / log1mq[rows])


def _btrs_consts(count: torch.Tensor, q: torch.Tensor) -> tuple:
    """BTRS's per-element constants (count, b, a, c, v_r, r, alpha, m, t1)
    for (C, K) counts and q. XLA contracts ``1.15 + 2.53 s``, both products
    of ``a`` and ``count q + 0.5`` into fused multiply-adds (``fma32``), and
    computes the bound's first term ``t1`` once, before the loop."""
    stddev = xla_math.sqrt(count * q * (1.0 - q))
    b = fma32(stddev, _c(2.53), _c(1.15))
    a = fma32(q, _c(0.01), fma32(b, _c(0.0248), _c(-0.0873)))
    c = fma32(count, q, 0.5)
    v_r = _c(0.92) - _c(4.2) / b
    r = q / (1.0 - q)
    alpha = (_c(2.83) + _c(5.1) / b) * stddev
    m = torch.floor((count + 1.0) * q)
    # the bound's first term is loop-invariant: XLA hoists it, rounded
    t1 = (m + 0.5) * xla_math.log((m + 1.0) / (r * (count - m + 1.0)))
    return count, b, a, c, v_r, r, alpha, m, t1


def _btrs_pass(consts: tuple, s0: torch.Tensor, s1: torch.Tensor) -> tuple:
    """One BTRS pass over (C, K) elements with constants ``consts`` (rows
    of ``_btrs_consts``) and the pass's subkeys s0, s1 (C, 2): each
    element's draw k and whether it accepts. XLA contracts ``k``'s ``(...)
    u + c`` and the bound's second and third log terms into fused
    multiply-adds."""
    n_, b_, a_, c_, v_r, r_, alpha, m_, t1 = consts
    K = n_.shape[1]
    u = prng.uniform(s0, (K,)) - 0.5
    v = prng.uniform(s1, (K,))
    us = 0.5 - torch.abs(u)
    accept1 = (us >= _c(0.07)) & (v <= v_r)
    k = torch.floor(fma32(2.0 * a_ / us + b_, u, c_))
    reject = (k < 0) | (k > n_)
    v = xla_math.log(v * alpha / (a_ / (us * us) + b_))
    ub = fma32(k + 0.5, xla_math.log(r_ * (n_ - k + 1.0) / (k + 1.0)),
               fma32(n_ + 1.0, xla_math.log((n_ - m_ + 1.0) / (n_ - k + 1.0)), t1))
    ub = (ub + _stirling_approx_tail(m_) + _stirling_approx_tail(n_ - m_)
          - _stirling_approx_tail(k) - _stirling_approx_tail(n_ - k))
    return k, accept1 | (~reject & (v <= ub))


def _btrs(keys: torch.Tensor, count: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s transformed-rejection sampler (BTRS) for a batch of
    calls, as ``_binomial_inversion``: a call loops while any element has
    not accepted, and every pass overwrites the draw of each element that
    accepts in it (the last accepted pass wins). Each pass: ``key, s0, s1
    = split(key, 3)``, then ``_btrs_pass``."""
    consts = _btrs_consts(count, q)
    k_out = torch.full_like(q, -1.0)
    accepted = torch.zeros_like(q, dtype=torch.bool)
    key = keys.clone()
    while True:
        rows = _rows_where((~accepted).any(1))
        if rows.numel() == 0:
            return k_out
        key[rows], s0, s1 = prng.split(key[rows], 3).unbind(-2)
        k, accept = _btrs_pass(tuple(x[rows] for x in consts), s0, s1)
        k_out[rows] = torch.where(accept, k, k_out[rows])
        accepted[rows] = accepted[rows] | accept


def binomial_calls(keys: torch.Tensor, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``binomial`` for C calls of K elements: keys (C, 2), n and p (C, K)
    float32 (p already clipped). Returns float32 draws before the
    wrapper's NaN and clip, ``jax.random``'s ``_binomial``: elements with
    ``n q <= 10`` (q = min(p, 1 - p)) take the inversion loop, the rest
    BTRS; both loops run over every element (inversion with count 0 for
    BTRS elements, BTRS with count 1e4 and q 1/2 for inversion elements),
    so an element's draw depends on the other elements of its call."""
    p_lt_half = p < 0.5
    q = torch.where(p_lt_half, p, 1.0 - p)
    bad_count = torch.isnan(n) | (n < 0)
    q_nan = torch.isnan(q)
    q_neg = q < 0
    q = torch.where(q_nan | q_neg, _c(0.01), q)
    use_inversion = bad_count | (n * q <= 10.0)
    count = torch.floor(n)
    inv = _binomial_inversion(keys, torch.where(use_inversion, count, 0.0), q)
    btrs = _btrs(keys, torch.where(use_inversion, 1e4, count),
                 torch.where(use_inversion, 0.5, q))
    samples = torch.where(use_inversion, inv, btrs)
    samples = torch.where(q_neg | q_nan | bad_count, float("nan"), samples)
    return torch.where(p_lt_half | bad_count | q_nan, samples, count - samples)


def binomial(key: torch.Tensor, n, p, shape=None) -> torch.Tensor:
    """Binomial(n, p) as int32, ``jax.random.binomial`` draw for draw.

    ``key`` (..., 2) is a batch of calls, as ``jax.vmap`` over keys; each
    call draws ``shape`` (default: the trailing broadcast shape of n and p
    without the batch axes) in lockstep (``binomial_calls``). p is clipped
    to [0, 1], a NaN draw becomes 0, and the draw is clipped to [0, n].
    """
    batch = tuple(key.shape[:-1])
    n = torch.as_tensor(n, device=key.device).to(torch.float32)
    p = torch.clamp(torch.as_tensor(p, device=key.device).to(torch.float32), 0.0, 1.0)
    if shape is None:
        shape = torch.broadcast_shapes(n.shape, p.shape)[len(batch):]
    full = batch + tuple(shape)
    n, p = n.expand(full), p.expand(full)
    calls = max(1, math.prod(batch))
    draw = binomial_calls(key.reshape(-1, 2), n.reshape(calls, -1), p.reshape(calls, -1))
    draw = draw.reshape(full)
    draw = torch.where(torch.isnan(draw), 0.0, draw)
    return torch.minimum(torch.clamp(draw, min=0.0), n).to(torch.int32)


def _gamma_log_one(keys: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``jax.random``'s ``_gamma_one`` with ``log_space=True`` for a batch of
    independent elements: keys (N, 2), alpha (N,) float32. Marsaglia and
    Tsang's squeeze: each outer pass splits its key three ways and draws
    normals (from the second) until ``v = 1 + x c > 0``, then a uniform;
    it stops when the squeeze or the log test accepts. An element's loops
    end on their own (``vmap``'s frozen carry), so the passes run over the
    live elements. Alphas below 1 take ``alpha + 1`` and add ``log(u) /
    alpha``. The alphas of every caller are constants, which XLA folds on
    the host: ``d``, ``c`` and ``log(d)`` are then correctly rounded (the
    float64 log rounded), not its CPU polynomial's."""
    boost = alpha >= 1.0
    a = torch.where(boost, alpha, alpha + 1.0)
    d = a - _c(1.0 / 3.0)
    c = _c(1.0 / 3.0) / xla_math.sqrt(d)
    key, subkey = prng.split(keys).unbind(-2)
    V = torch.ones_like(alpha)
    live = torch.ones_like(boost)
    while True:
        rows = _rows_where(live)
        if rows.numel() == 0:
            break
        key[rows], x_key, u_key = prng.split(key[rows], 3).unbind(-2)
        c_r = c[rows]
        x = torch.zeros_like(c_r)
        v = torch.full_like(c_r, -1.0)
        while True:
            redo = _rows_where(v <= 0.0)
            if redo.numel() == 0:
                break
            x_key[redo], sub = prng.split(x_key[redo]).unbind(-2)
            x[redo] = prng.normal(sub, ())
            v[redo] = fma32(x[redo], c_r[redo], 1.0)
        X = x * x
        vv = (v * v) * v
        U = prng.uniform(u_key, ())
        squeeze = U >= fma32(_c(-0.0331), X * X, 1.0)
        log_test = xla_math.log(U) >= fma32(d[rows], (1.0 - vv) + xla_math.log(vv), X * 0.5)
        V[rows] = vv
        live[rows] = squeeze & log_test
    log_u = xla_math.log1p(-prng.uniform(subkey, ()))
    log_boost = torch.where(boost | (log_u == 0), 0.0, log_u * (1.0 / alpha))
    log_d = torch.log(d.double()).float()
    return (log_d + xla_math.log(V)) + log_boost


def loggamma(key: torch.Tensor, alpha, shape) -> torch.Tensor:
    """``jax.random.loggamma``: ``key`` (..., 2), one split per element."""
    shape = tuple(shape)
    n = math.prod(shape)
    keys = prng.split(key, n).reshape(-1, 2)
    batch = tuple(key.shape[:-1])
    a = torch.as_tensor(alpha, dtype=torch.float32, device=key.device).expand(batch + shape)
    return _gamma_log_one(keys, a.reshape(-1).clone()).reshape(batch + shape)


def beta(key: torch.Tensor, a, b, shape) -> torch.Tensor:
    """``jax.random.beta``: ``key`` (..., 2), draws ``(..., *shape)``, from the
    two log-gamma draws, ``exp(la - m) / (exp(la - m) + exp(lb - m))``."""
    key_a, key_b = prng.split(key).unbind(-2)
    la = loggamma(key_a, a, shape)
    lb = loggamma(key_b, b, shape)
    top = torch.maximum(la, lb)
    ga = xla_math.exp(la - top)
    gb = xla_math.exp(lb - top)
    return ga / (ga + gb)


def rev_normal_cents(key: torch.Tensor, mean, std, shape) -> torch.Tensor:
    """Per-conversion revenue draws in int32 cents: ``round(max(N(mean,
    std), 0.01), 2)`` in cents, as the lanes day takes them
    (``adcraft_tpu/step.py:981``): ``round(max(mean + std z, 0.01) * 100)``.
    XLA folds the normal's ``sqrt(2)`` into ``std`` (one rounded product),
    contracts the sum into a fused multiply-add, and drops the division and
    second rounding of ``round_cents``, which change no cent."""
    erf = prng.normal_erfinv(key, shape)
    draw = torch.clamp(fma32(std * xla_math.SQRT2, erf, mean), min=_c(0.01))
    return torch.round(draw * 100.0).to(torch.int32)


def binomial_inv_u(u: torch.Tensor, n, p, nmax: int) -> torch.Tensor:
    """Binomial(n, p) by the inverse-CDF walk at the uniform ``u``.

    ``count = #{j < nmax : P(X <= j) < u}``, clipped to [0, n], on q =
    min(p, 1 - p) with the count flipped when p > 1/2; the pmf by the
    ratio recurrence, one level at a time, as ``binomial_inv`` walks it;
    ``pmf0 = (1 - q)^n`` is XLA's ``powf`` (``xla_math.pow``).
    """
    n = torch.as_tensor(n, device=u.device).to(torch.float32)
    p = torch.clamp(torch.as_tensor(p, device=u.device).to(torch.float32), 0.0, 1.0)
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    r = q / (1.0 - q)
    pmf = xla_math.pow(1.0 - q, n)
    cdf = pmf
    cnt = (cdf < u).to(torch.int32)
    for j in range(1, nmax):
        pmf = torch.clamp(pmf * ((n - float(j - 1)) * (r * recip(j))), min=0.0)
        cdf = cdf + pmf
        cnt = cnt + (cdf < u).to(torch.int32)
    ni = torch.round(n).to(torch.int32)
    cnt = torch.minimum(torch.clamp(cnt, min=0), ni)
    return torch.where(flip, ni - cnt, cnt)


def binomial_inv(key, n, p, nmax: int, bits: int = 32, shape=None) -> torch.Tensor:
    """Binomial(n, p) draws by the inverse-CDF walk, one uniform each."""
    if shape is None:
        shape = torch.broadcast_shapes(torch.as_tensor(n).shape, torch.as_tensor(p).shape)
        shape = shape[key.dim() - 1:]
    return binomial_inv_u(lane_uniform(key, shape, bits), n, p, nmax)


def binomial_cdf(n, p, nmax: int):
    """``binomial_inv``'s CDF ladder for fixed (n, p): ``(cdf, flip, ni)``,
    ``cdf`` of shape ``(nmax + 1, *shape)``, by a cumulative product and
    a cumulative sum in XLA's order (``xla_math.cumprod``, ``cumsum``; not
    the walk's order of rounding)."""
    n = torch.as_tensor(n).to(torch.float32)
    p = torch.clamp(torch.as_tensor(p, device=n.device).to(torch.float32), 0.0, 1.0)
    n, p = torch.broadcast_tensors(n, p)
    flip = p > 0.5
    q = torch.where(flip, 1.0 - p, p)
    r = q / (1.0 - q)
    j = torch.arange(1, nmax + 1, dtype=torch.float32, device=n.device)
    j = j.reshape((nmax,) + (1,) * n.dim())
    f = torch.clamp((n[None] - (j - 1.0)) / j * r[None], min=0.0)
    pmf0 = xla_math.pow(1.0 - q, n)
    pmf = torch.cat([pmf0[None], xla_math.ftz(pmf0[None] * xla_math.cumprod(f, 0))])
    cdf = xla_math.cumsum(pmf, 0)
    return cdf, flip, torch.round(n).to(torch.int32)


def binomial_inv_from_cdf_u(u: torch.Tensor, cdf: torch.Tensor, flip, ni) -> torch.Tensor:
    """One inverse-CDF draw at ``u`` against a ladder ``cdf`` whose first
    axis holds at least the ``nmax`` levels compared."""
    cnt = (cdf < u[None]).sum(0, dtype=torch.int32)
    cnt = torch.minimum(torch.clamp(cnt, min=0), ni)
    return torch.where(flip, ni - cnt, cnt)


def binomial_inv_from_cdf(key, ladder, bits: int = 32) -> torch.Tensor:
    """One draw against a ``binomial_cdf`` ladder, the walk's uniform."""
    cdf, flip, ni = ladder
    nmax = cdf.shape[0] - 1
    u = lane_uniform(key, tuple(cdf.shape[1 + key.dim() - 1:]), bits)
    return binomial_inv_from_cdf_u(u, cdf[:nmax], flip, ni)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.special.ndtr`` on XLA's erf and erfc."""
    w = x * _INV_SQRT2
    z = torch.abs(w)
    y = torch.where(z < _INV_SQRT2, 1.0 + xla_math.erf(w),
                    torch.where(w > 0, 2.0 - xla_math.erfc(z), xla_math.erfc(z)))
    return y * 0.5


def normal_pdf(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.stats.norm.pdf``: ``exp(-(x**2 + log(2 pi)) / 2)``."""
    return xla_math.exp(fma32(x, x, _c(math.log(2.0 * math.pi))) * -0.5)


def censored_normal_moments(mean, std, low: float):
    """Mean and std of ``max(N(mean, std), low)``; std 0 gives (max(mean,
    low), 0). Sums of products fuse as XLA fuses them."""
    mean = torch.as_tensor(mean).to(torch.float32)
    std = torch.as_tensor(std).to(torch.float32)
    safe = torch.clamp(std, min=1e-20)
    a = (low - mean) / safe
    big_f, small_f = ndtr(a), normal_pdf(a)
    rest = 1.0 - big_f
    m1 = fma32(safe, small_f, fma32(_c(low), big_f, mean * rest))
    m2 = fma32(_c(low * low), big_f, fma32(mean, mean, safe * safe) * rest)
    m2 = fma32(safe * (mean + low), small_f, m2)
    var = torch.clamp(fma32(-m1, m1, m2), min=0.0)
    deg = std <= 0.0
    m1 = torch.where(deg, torch.clamp(mean, min=low), m1)
    var = torch.where(deg, torch.zeros_like(var), var)
    return m1, xla_math.sqrt(var)


def rev_sum_moments(rev_mean, rev_std):
    """Per-conversion revenue moments in cents for ``rev_sum_cents``:
    ``(100 m1, sqrt((100 s1)**2 + 1/12))`` of the censored normal at $0.01."""
    m1, s1 = censored_normal_moments(rev_mean, rev_std, 0.01)
    h = 100.0 * s1
    return 100.0 * m1, xla_math.sqrt(fma32(h, h, _c(1.0 / 12.0)))


def rev_sum_cents_z(z, nconv, mean_c, std_c, rev_std) -> torch.Tensor:
    """``rev_sum_cents`` at the standard normal ``z``, int32 cents."""
    n = nconv.to(torch.float32)
    clt = torch.round(fma32(n, mean_c, torch.sqrt(n) * std_c * z))
    exact = n * torch.round(mean_c)
    cents = torch.maximum(torch.where(rev_std <= 0.0, exact, clt), n)
    return torch.where(nconv > 0, cents, torch.zeros_like(cents)).to(torch.int32)


def rev_sum_cents(key, nconv, rev_mean, rev_std) -> torch.Tensor:
    """Aggregate revenue of ``nconv`` conversions in int32 cents: one
    normal with the censored per-conversion moments, rounded, floored at
    one cent per conversion, exact when ``rev_std`` is 0."""
    mean_c, std_c = rev_sum_moments(rev_mean, rev_std)
    z = prng.normal(key, tuple(nconv.shape[key.dim() - 1:]))
    return rev_sum_cents_z(z, nconv, mean_c, std_c, rev_std)


def single_cost_cent_moments_closed(bid, loc, scale):
    """Per-click cost moments in cents of the single-competitor auction,
    in closed form: (mean, std, cmax), ``cmax = bid_cents - 1``.

    The per-click cost is ``100 * round(|L|, 2)`` for ``L ~ Laplace(loc,
    scale)`` conditioned on ``|L| < bid - 0.005``; the JAX docstring
    derives the geometric sums term by term, and this follows it line for
    line, on XLA's ``exp`` and ``expm1`` and with the products that XLA
    contracts into the sums after them as ``fma32``: both equal jitted
    XLA's bit for bit. LLVM contracts, of a sum's two products, the one
    with fewer uses, so a fusion that uses a product twice contracts the
    other one. XLA computes the std in a fusion of its own that recomputes
    the first moment's sums, and there ``s3`` has two uses: its
    ``sum_a_top`` contracts ``n_top e_ya`` where the mean's contracts ``t3
    geo0_top`` (read off the dumped IR, ``XLA_FLAGS=--xla_dump_to=DIR``).
    """
    bid = torch.as_tensor(bid).to(torch.float32)
    a = torch.abs(torch.as_tensor(loc).to(torch.float32))
    s = torch.clamp(torch.as_tensor(scale).to(torch.float32), min=1e-12)
    bid, a, s = torch.broadcast_tensors(bid, a, s)

    y0 = torch.clamp(bid - 0.005, min=0.0)
    c = 1.0 / (100.0 * s)
    bc = torch.round(bid * 100.0)
    big_i = torch.clamp(bc - 1.0, min=0.0)
    m = torch.minimum(torch.clamp(torch.ceil(fma32(a, 100.0, -0.5)), min=0.0), big_i)
    em1 = -xla_math.expm1(-c)

    def geo0(n):
        return -xla_math.expm1(-n * c) / em1

    def geo1(n):
        e1 = xla_math.exp(-(n - 1.0) * c)
        e2 = xla_math.exp(-n * c)
        return (xla_math.exp(-c) * fma32(n - 1.0, e2, fma32(-n, e1, 1.0))) / (em1 * em1)

    def safe_exp(x):
        return xla_math.exp(torch.clamp(x, max=0.0))

    e_ay = safe_exp(-(a - y0) / s)
    b_fac = safe_exp(-(a + 0.005) / s)
    b_cut = safe_exp(-(a + y0) / s)
    geo0_i, geo1_i = geo0(big_i), geo1(big_i)
    half_ii = (0.5 * big_i) * (big_i - 1.0)
    sum_b = 0.5 * fma32(b_fac, geo0_i, -(big_i * b_cut))
    sum_ib = 0.5 * fma32(b_fac, geo1_i, -(half_ii * b_cut))

    def r2(n, g0, g1):
        t2 = safe_exp(-(fma32(a, 100.0, -n) + 0.5) * c)
        return t2 * g0, t2 * fma32(n - 1.0, g0, -g1)

    r2_i, r2w_i = r2(big_i, geo0_i, geo1_i)
    sum_a_low = 0.5 * fma32(big_i, e_ay, -r2_i)
    sum_ia_low = 0.5 * fma32(half_ii, e_ay, -r2w_i)

    e_ya = safe_exp(-(y0 - a) / s)
    r2_m, r2w_m = r2(m, geo0(m), geo1(m))
    keep = 1.0 - 0.5 * e_ya
    sum_a_pre = fma32(m, keep, -(0.5 * r2_m))
    sum_ia_pre = fma32((0.5 * m) * (m - 1.0), keep, -(0.5 * r2w_m))
    n_top = big_i - m
    t3 = xla_math.exp(torch.clamp(-fma32(a, -100.0, m + 0.5) * c, max=30.0))
    geo0_top = geo0(n_top)
    s3 = t3 * geo0_top
    s3w = fma32(m, s3, t3 * geo1(n_top))
    sum_a_top = 0.5 * fma32(t3, geo0_top, -(n_top * e_ya))
    sum_a_top_std = 0.5 * fma32(-n_top, e_ya, s3)
    sum_i_top = (0.5 * (big_i - 1.0 + m)) * n_top
    sum_ia_top = 0.5 * s3w - (0.5 * sum_i_top) * e_ya

    low = y0 <= a
    sum_a = torch.where(low, sum_a_low, sum_a_pre + sum_a_top)
    sum_a_std = torch.where(low, sum_a_low, sum_a_pre + sum_a_top_std)
    sum_ia = torch.where(low, sum_ia_low, sum_ia_pre + sum_ia_top)

    z = laplace_cdf(y0, a, s) - laplace_cdf(-y0, a, s)
    zsafe = torch.clamp(z, min=1e-12)
    tail0 = torch.clamp(sum_a + sum_b, min=0.0)
    tail1 = torch.clamp(sum_ia + sum_ib, min=0.0)
    mu = tail0 / zsafe
    m2 = (2.0 * tail1 + torch.clamp(sum_a_std + sum_b, min=0.0)) / zsafe
    var = torch.clamp(fma32(-mu, mu, m2), min=0.0)
    return mu, xla_math.sqrt(var), torch.clamp(bc - 1.0, min=0.0)


# ---- explicit keywords: the impression rate, both cost models and their
# per-click moments (adcraft_tpu/distributions.py:307-512). All follow
# jitted XLA on the CPU bit for bit: its exp, erf and erfc
# (``xla_math``), its fused multiply-adds (``fma32``), its reciprocal of a
# constant divisor, and its flush of subnormal results to zero ----

RUST_COST_PLACEHOLDER = 4.4  # rust cost_create's fill value: p/2 term and clamp ceiling
_SIXTH = _c(1.0 / 6.0)


def threshold_sigmoid(bid, thresh, intercept, slope) -> torch.Tensor:
    """Thresholded sigmoid impression rate: with ``c = clip(2 thresh, 0,
    1)``, ``clip((1 + c) sigmoid(slope (bid - intercept)) - c / 2, 0, 1)``.
    (The source's ``2 + 1e-10`` is 2 in float32, and XLA folds its halving
    and doubling into these.)"""
    c = torch.clamp(thresh * 2.0, 0.0, 1.0)
    r = xla_math.sigmoid(slope * (bid - intercept))
    return torch.clamp(fma32(r, c + 1.0, -(c * 0.5)), 0.0, 1.0)


def _cost_noise_std(s: torch.Tensor) -> torch.Tensor:
    """``1e-10 + sqrt(bid) / 6``, the cost models' noise std, with XLA's
    contraction."""
    return fma32(s, _SIXTH, _c(1e-10))


def cost_create_e(e: torch.Tensor, bid) -> torch.Tensor:
    """``cost_create`` at ``e = erf_inv(u)`` of the normal's uniform:
    ``clip(sqrt(bid)/4 + 2.2 + N(0, 1e-10 + sqrt(bid)/6), 0, 4.4)``, the
    normal's ``sqrt(2)`` folded into its std as XLA folds it."""
    s = xla_math.sqrt(torch.as_tensor(bid, dtype=torch.float32))
    raw = fma32(_cost_noise_std(s) * xla_math.SQRT2, e, fma32(s, 0.25, _c(2.2)))
    return torch.clamp(raw, 0.0, _c(RUST_COST_PLACEHOLDER))


def generic_cost_e(e: torch.Tensor, bid) -> torch.Tensor:
    """``generic_cost`` at ``e = erf_inv(u)``: ``round(clip(sqrt(bid)/4 +
    bid/2 + N(0, 1e-10 + sqrt(bid)/6), 0, bid), 2)``."""
    bid = torch.as_tensor(bid, dtype=torch.float32)
    s = xla_math.sqrt(bid)
    raw = fma32(_cost_noise_std(s) * xla_math.SQRT2, e, s * 0.25 + bid * 0.5)
    return torch.round(torch.minimum(torch.clamp(raw, min=0.0), bid) * 100.0) * _c(0.01)


def cost_create(key, bid, shape) -> torch.Tensor:
    """Rust ``cost_create`` draws (continuous, not rounded), float32."""
    return cost_create_e(prng.normal_erfinv(key, shape), bid)


def generic_cost(key, bid, shape) -> torch.Tensor:
    """Python ``generic_cost`` draws, rounded to cents, float32."""
    return generic_cost_e(prng.normal_erfinv(key, shape), bid)


def clipped_normal_moments(mean, std, low: float, high: float):
    """Mean and std of ``clip(N(mean, std), low, high)``; std 0 gives
    (clip(mean, low, high), 0). Sums of products fuse as XLA fuses them
    for ``low = 0`` (the only bound the models use)."""
    mean = torch.as_tensor(mean).to(torch.float32)
    std = torch.as_tensor(std).to(torch.float32)
    safe = torch.clamp(std, min=1e-20)
    a = (low - mean) / safe
    b = (high - mean) / safe
    fa, fb = ndtr(a), ndtr(b)
    pa, pb = normal_pdf(a), normal_pdf(b)
    mid, dp, ss = fb - fa, pa - pb, safe * safe
    m1 = xla_math.ftz(fma32(safe, dp, fma32(mean, mid, fma32(_c(high), 1.0 - fb, low * fa))))
    m2 = fma32(_c(high * high), 1.0 - fb, _c(low * low) * fa)
    m2 = fma32(fma32(mean, mean, ss), mid, m2)
    m2 = fma32((mean * 2.0) * safe, dp, m2)
    m2 = fma32(ss, fma32(a, pa, -(b * pb)), m2)
    var = xla_math.ftz(torch.clamp(fma32(-m1, m1, m2), min=0.0))
    deg = std <= 0.0
    m1 = torch.where(deg, torch.clamp(mean, low, high), m1)
    var = torch.where(deg, torch.zeros_like(var), var)
    return m1, xla_math.sqrt(var)


def cost_create_deci_moments(bid):
    """Per-click ``cost_create`` moments in decicents: (1000 m1, sqrt((1000
    s1)**2 + 1/12), 4400) of the clipped normal on [0, 4.4]."""
    s = xla_math.sqrt(torch.as_tensor(bid).to(torch.float32))
    m1, s1 = clipped_normal_moments(fma32(s, 0.25, _c(2.2)), _cost_noise_std(s), 0.0,
                                    RUST_COST_PLACEHOLDER)
    h = s1 * 1000.0
    sig = xla_math.sqrt(fma32(h, h, _c(1.0 / 12.0)))
    return m1 * 1000.0, sig, torch.full_like(m1, _c(RUST_COST_PLACEHOLDER * 1000.0))


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in XLA's CPU order: past 32 terms, padded
    with zeros on both sides to windows of 32, each window summed in order,
    then the window sums (the tree reduction rewrite); else in order."""
    n = x.shape[0]
    if n > 32:
        pad = -n % 32
        z = x.new_zeros((1,) + tuple(x.shape[1:]))
        x = torch.cat([z.expand((pad // 2,) + z.shape[1:]), x,
                       z.expand((pad - pad // 2,) + z.shape[1:])])
        x = x.reshape((-1, 32) + tuple(x.shape[1:]))
        return _tree_sum(torch.stack([_tree_sum(w) for w in x]))
    total = torch.zeros_like(x[0])
    for term in x:
        total = total + term
    return total


def generic_cost_cent_moments(bid, grid: int):
    """Per-click ``generic_cost`` moments in cents: (mean, std, round(100
    bid)), Abel sums of the normal's tail over the cent grid's ``grid``
    cells (exact for ``bid <= grid / 100``). XLA's order of the sums is
    followed for ``grid > 32`` (the tree reduction); smaller grids sum in
    another order there, which ``step.check_xla_config`` refuses."""
    bid = torch.as_tensor(bid).to(torch.float32)
    s = xla_math.sqrt(bid)
    mu_r = s * 0.25 + bid * 0.5
    sig_r = _cost_noise_std(s)
    i = torch.arange(grid, dtype=torch.float32, device=bid.device)
    i = i.reshape((grid,) + (1,) * bid.dim())
    edge = (i + 0.5) * _c(0.01)
    g = ndtr((torch.minimum(edge, bid) - mu_r) / sig_r)
    tail = torch.clamp(1.0 - torch.where(edge >= bid, 1.0, g), min=0.0)
    mu = _tree_sum(tail)
    m2 = _tree_sum(fma32(i, 2.0, 1.0) * tail)
    var = torch.clamp(fma32(-mu, mu, m2), min=0.0)
    return mu, xla_math.sqrt(var), torch.round(bid * 100.0)


def agg_cost_cents_z(z, n_clicks, mu, sigma, cmax, cmin=None) -> torch.Tensor:
    """``agg_cost_cents`` at the standard normal ``z``, int32 units."""
    n = n_clicks.to(torch.float32)
    s = torch.round(fma32(n, mu, torch.sqrt(n) * sigma * z))
    s = torch.clamp(s, min=0.0) if cmin is None else torch.maximum(s, n * cmin)
    return torch.minimum(s, n * cmax).to(torch.int32)


def agg_cost_cents(key, n_clicks, mu, sigma, cmax, cmin=None, bits: int = 32) -> torch.Tensor:
    """One aggregate spend draw per cell in int32 units (cents, or the
    pool's decicents): ``N(n mu, n sigma**2)`` rounded and clipped to [n
    cmin, n cmax], ``cmin`` 0 by default (the binomial pool's k >= 3 cells
    pass ``-cmax``: a losing pool's maximum bid can be negative). 16-bit
    normals (``agg_draw_bits=16``) are not ported (ROADMAP.md item 2)."""
    if bits != 32:
        raise NotImplementedError("agg_cost_cents: 16-bit normals are not ported (ROADMAP.md)")
    z = prng.normal(key, tuple(n_clicks.shape[key.dim() - 1:]))
    return agg_cost_cents_z(z, n_clicks, mu, sigma, cmax, cmin)


# ---- the binomial pool (adcraft_tpu/distributions.py:732-868): a cell's
# k ~ Binomial(max_bidders, participation) competitors, each bidding a raw
# Laplace(loc, scale); a won click costs the maximum of the k bids given
# that it is below ours, M = F^-1(F(bid) u^(1/k)), floored at 0 where k <
# 3 and 0 where k = 0 ----

POOL_QUAD_NODES = 48


@functools.lru_cache(maxsize=None)
def pool_quad(kmax: int):
    """The pool moments' Gauss-Legendre rule on (0, 1), from numpy's
    ``leggauss`` as the JAX package builds it: float32 nodes w_q and
    weights omega_q (Q,), and the node powers ``W[q, j] = w_q ** j``, j =
    k - 1 < ``kmax``, raised in float64 then rounded (Q, kmax)."""
    x, w = np.polynomial.legendre.leggauss(POOL_QUAD_NODES)
    nodes = 0.5 * (x + 1.0)
    powers = nodes[:, None] ** np.arange(kmax)[None, :]
    return nodes.astype(np.float32), (0.5 * w).astype(np.float32), powers.astype(np.float32)


@functools.lru_cache(maxsize=None)
def pool_quad_tensors(kmax: int, device: torch.device):
    """``pool_quad(kmax)`` as float32 tensors on ``device``, built once."""
    return tuple(torch.from_numpy(a).to(device) for a in pool_quad(kmax))


def pool_icdf_arg(x: torch.Tensor) -> torch.Tensor:
    """``clip(x, 1e-38, 1 - 1e-12)`` as XLA's CPU computes it: the bound
    1e-38 is subnormal, which XLA's code reads as 0 (a result below
    float32's normal range is 0), and 1 - 1e-12 is 1 in float32."""
    return xla_math.ftz(torch.clamp(x, 1e-38, 1.0))


def pool_g(bid, loc, scale, kmax: int = 32, cent_bids: bool = False) -> torch.Tensor:
    """The pool moments' k-independent rows ``g_q = F^-1(F(bid) w_q)``,
    (Q, ...) float32, one per quadrature node (F(bid) as ``bid_cdf``)."""
    bid, loc, scale = (torch.as_tensor(x).to(torch.float32) for x in (bid, loc, scale))
    nodes = pool_quad_tensors(kmax, bid.device)[0]
    wq = nodes.reshape((POOL_QUAD_NODES,) + (1,) * bid.dim())
    f_bid = bid_cdf(bid, loc, scale, cent_bids)
    return laplace_icdf(pool_icdf_arg(f_bid[None] * wq), loc[None], scale[None])


def pool_moment_sums(g: torch.Tensor, k: torch.Tensor, kmax: int):
    """``(A1, A2)`` at each cell's column j = k - 1 (k in 1..kmax): the
    48-node contractions ``sum_q W[q, j] omega_q g_q^r`` (r = 1, 2), with g
    floored at 0 where k < 3, each one chain of fused multiply-adds in node
    order as jitted XLA contracts ``tensordot(W, omega g^r)``. ``g`` (Q,
    ...), ``k`` (...) float32."""
    _, omega, W = pool_quad_tensors(kmax, g.device)
    j = torch.clamp(k - 1.0, 0.0, kmax - 1.0).to(torch.int64)
    gr = torch.where(k < 3.0, torch.clamp(g, min=0.0), g)
    a1 = torch.zeros_like(k)
    a2 = torch.zeros_like(k)
    for q in range(POOL_QUAD_NODES):
        wq = W[q][j]
        a1 = fma32(wq, omega[q] * gr[q], a1)
        a2 = fma32(wq, omega[q] * (gr[q] * gr[q]), a2)
    return a1, a2


def pool_cost_deci_moments(bid, loc, scale, k, kmax: int = 32):
    """Per-click cost moments of the binomial pool in decicents given the
    cell's bidder count ``k`` (1 <= k <= ``kmax``, the table width
    ``EnvConfig.max_bidders_bound``): (mu, sigma, cmax), sigma with the
    1/12 quantization variance, cmax ``round(1000 bid)``; all 0 where k =
    0. ``E[M^r | k] = k sum_q omega_q g_q^r w_q^(k-1)`` (Gauss-Legendre over
    u = w^k). For every k both packages share a column, it equals the JAX
    function bit for bit; JAX's table has 33 columns and its one-hot reads
    a k above 33 at column 33, where this reads column k."""
    bid, loc, scale, k = (torch.as_tensor(x).to(torch.float32) for x in (bid, loc, scale, k))
    bid, loc, scale, k = torch.broadcast_tensors(bid, loc, scale, k)
    return pool_deci_moments_of(*pool_moment_sums(pool_g(bid, loc, scale, kmax), k, kmax), k, bid)


def pool_deci_moments_of(a1, a2, k, bid):
    """``pool_cost_deci_moments`` from a cell's sums ``pool_moment_sums``:
    mu = 1000 (k A1), var = max(m2 - mu^2, 0) for m2 = k A2 (one fused
    multiply-add), sigma = sqrt(1e6 var + 1/12) (another)."""
    zero_k = k <= 0.0
    mu = torch.where(zero_k, 0.0, k * a1)
    m2 = torch.where(zero_k, 0.0, k * a2)
    var = torch.clamp(fma32(-mu, mu, m2), min=0.0)
    sig = xla_math.sqrt(fma32(1e6, var, torch.where(zero_k, 0.0, _c(1.0 / 12.0))))
    cmax = torch.round(1000.0 * bid) * torch.where(zero_k, 0.0, 1.0)
    return 1000.0 * mu, sig, cmax


def pool_cost_u(u: torch.Tensor, f_bid, loc, scale, k) -> torch.Tensor:
    """A pool click's cost in dollars at the uniform ``u``, given ``f_bid =
    F(bid)`` and the cell's bidder count ``k``: ``F^-1(F(bid) u^(1/k))``
    (``u ** (1 / k)`` XLA's ``powf``, ``1 / k`` a true division), floored
    at 0 where k < 3, 0 where k = 0."""
    ksafe = torch.clamp(k, min=1.0)
    m = laplace_icdf(pool_icdf_arg(f_bid * xla_math.pow(u, 1.0 / ksafe)), loc, scale)
    m = torch.where(k < 3.0, torch.clamp(m, min=0.0), m)
    return torch.where(k <= 0.0, 0.0, m)


def pool_cost_lane_draws(key, bid, loc, scale, k, shape, bits: int = 32) -> torch.Tensor:
    """Per-click pool cost draws in dollars (the agg route's lite and deep
    lanes), ``pool_cost_u`` at ``bits``-bit lane uniforms."""
    u = lane_uniform(key, shape, bits)
    return pool_cost_u(u, laplace_cdf(bid, loc, scale), loc, scale, k)


def probify(x: torch.Tensor) -> torch.Tensor:
    """Clip to [0, 1]."""
    return torch.clamp(x, 0.0, 1.0)


def nonnegify(x: torch.Tensor) -> torch.Tensor:
    """Clip below at 0."""
    return torch.clamp(x, min=0.0)


def round_cents(x: torch.Tensor) -> torch.Tensor:
    """Round to 2 decimals, half to even (``np.around(x, 2)``), as jitted
    XLA computes ``round(x * 100) / 100``: the division by the constant a
    product with its float32 reciprocal (``recip``)."""
    return torch.round(x * 100.0) * recip(100.0)


def int32_of(x: torch.Tensor) -> torch.Tensor:
    """float32 to int32 as XLA converts it: toward zero, saturating at both
    ends (``inf`` to INT32_MAX, ``-inf`` to INT32_MIN) and NaN to 0, where
    torch's CPU cast wraps (``inf`` to INT32_MIN)."""
    c = torch.nan_to_num(x, nan=0.0).clamp(-(2.0**31), 2.0**31)
    return c.to(torch.int64).clamp(-(2**31), 2**31 - 1).to(torch.int32)


def cents_int32(money, scale: float = 100.0) -> torch.Tensor:
    """``round(money * scale)`` in float32 (cents by default), converted to
    int32 as XLA converts float32 (``int32_of``). The budget in the gate's
    unit on both day routes (``adcraft_tpu/step.py:1211-1218``,
    ``pallas_kernels.py:272-274``)."""
    return int32_of(torch.round(torch.as_tensor(money).to(torch.float32) * scale))


def nonneg_int_normal(key: torch.Tensor, mean, std, shape=None) -> torch.Tensor:
    """``round(max(N(mean, std), 0))`` as int32.

    ``key`` may carry leading batch axes; the draw then has shape
    ``(*batch, *shape)``, ``shape`` defaulting to the trailing broadcast
    shape of ``mean`` and ``std`` without the batch axes.
    """
    mean = torch.as_tensor(mean, dtype=torch.float32, device=key.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=key.device)
    if shape is None:
        batch = key.dim() - 1
        shape = torch.broadcast_shapes(mean.shape, std.shape)[batch:]
    # jitted XLA contracts the draw into a fused multiply-add
    draw = fma32(std, prng.normal(key, shape), mean)
    return torch.round(torch.clamp(draw, min=0.0)).to(torch.int32)
