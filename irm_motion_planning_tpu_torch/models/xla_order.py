"""The JAX package's float32 arithmetic on the CPU, written out as plain
tensor operations so that the CPU and the card give its bits.

The single-scene solvers and the warm start are chaotic in the roundings of
their basis products: the coefficients are O(1e3-1e4) and the products
cancel them to O(1), so one product rounded another way moves a solve as
much as a change of scene.  XLA's CPU code, where the JAX package's
single-scene solve runs, rounds these products in a fixed order, with fused
multiply-adds; this module reproduces that order (measured against jax
0.9's CPU backend, tests/test_torch_xla_order.py):

* :func:`basis_product`, ``m @ x`` for a basis matrix ``m`` (M, K), K >= 4
  (XLA's runtime dot): four partial sums, term k going to sum ``k mod 4``,
  each a chain of fused multiply-adds from zero over the first
  ``4 (K // 4)`` terms; the four added as ``(s0 + s1) + (s2 + s3)``; the
  last ``K mod 4`` products, each rounded, summed in order and added last;
* :func:`mix_product`, ``a @ mix`` for the J x J mixing matrix: at J = 3
  (XLA's inlined loop, 8 rows to a vector) the first two columns as
  ``(p0 + p1) + p2`` of rounded products and the third as two fused
  multiply-adds on the vector rows, every column by fused multiply-adds on
  the remaining ``M mod 8`` rows; at other J one chain of fused
  multiply-adds or the runtime dot's order with four or two partial sums,
  by shape (:func:`mix_chains`).

The JAX package's fused kernel, run by Pallas's interpreter on the CPU
(``interpret=True``: the kernel body becomes XLA ops in the same program),
rounds in more ways, each reproduced here and tested against jax 0.9 on
an x86-64 CPU with AVX2 and FMA (tests/test_torch_xla_order.py; the
lines' shapes are those that ``fused_solve`` at T = 200 and a tile of 64
lanes gives the ops; tools/carry_replica.py puts them into the plain K1):

* :func:`interp_recip`, ``pl.reciprocal(s, approx=True)`` as the
  interpreter runs it, and its Newton step;
* :func:`sin`, :func:`cos`, XLA's CPU ``sin``/``cos`` of float32: glibc's
  ``sinf``/``cosf`` (XLA calls them element by element), computed in
  float64 with a polynomial after a reduction by pi/2;
* :func:`rsqrt`, XLA's CPU ``rsqrt``: the CPU's ``vrsqrtps`` estimate,
  then two Newton steps with fused multiply-adds;
* :func:`tree_sum`, XLA's CPU sum over a leading axis: windows of 32;
* :func:`lane_product`, XLA's CPU runtime dot of a basis matrix by a tile
  of lanes, ``(M, K) @ (K, N)``, whose order depends on N.

And the JAX package's basis build (models/rkhs.py ``build_basis``) takes
:func:`exp`, XLA's CPU ``exp`` of float32 (Cephes' polynomial).

A fused multiply-add of float32 values is emulated by :func:`fma_`, one
``addcmul`` with an operand in float64: the product is exact there, and the
float64 sum is rounded to float32 on the store.  Where that float64 sum is
not exact and lies on a float32 midpoint it is rounded twice, and may land
one float32 ulp from a true fused multiply-add: 1 of the 5,990,169,600
chain steps of the sequential oracle on 128 of JAX's oracle scenes, whose
converged flags all stayed JAX's (tools/warm_start_crossing.py).  An exact
emulation (the sum's error term by TwoSum, the midpoint case corrected)
took some 16 operations a step, and made one warm start at T = 50 take
33.1 ms on an H100 against 4.8 ms with this one (tools/single_scene_timing.py).
Every value between the steps is a float32 value.
"""

from __future__ import annotations

import torch

_F64 = torch.float64
# XLA's runtime dot: partial sums; its inlined loops: rows per vector.
CHAINS = 4
VECTOR = 8


def fma_(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         value: float = 1.0) -> torch.Tensor:
    """``acc += value * a * b`` in place, float32 ``acc`` and float32 values
    in ``a``, ``b`` (one of them float64, broadcasting; ``value`` +-1): the
    product in float64, exact, then the sum rounded to float32 (see the
    module docstring for the one case this rounds twice)."""
    return acc.addcmul_(a, b, value=value)


def basis_product(m: torch.Tensor, x: torch.Tensor,
                  chains: int = CHAINS) -> torch.Tensor:
    """``m @ x`` for a float32 matrix ``m`` (M, K) and ``x`` (..., K, J),
    rounded as XLA's CPU runtime dot rounds it (K >= 4; see the module
    docstring): ``chains`` partial sums, term k to sum ``k mod chains``,
    added pairwise, then the plain tail; every lane's bits are its own.
    The chains run with the rows innermost, (chain, J, lanes, M)."""
    M, K = m.shape
    J = x.shape[-1]
    lanes = x.reshape(-1, K, J)
    L = lanes.shape[0]
    S = K // chains
    mt = m.to(_F64)[:, :S * chains].T.reshape(S, chains, 1, 1, M)
    xt = (lanes[:, :S * chains, :].to(_F64).permute(1, 2, 0)
          .reshape(S, chains, J, L, 1))
    acc = torch.zeros((chains, J, L, M), dtype=torch.float32, device=x.device)
    for t in range(S):
        fma_(acc, mt[t], xt[t])
    sums = list(acc)
    while len(sums) > 1:                        # (s0 + s1) + (s2 + s3)
        sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
    out = sums[0]
    mk = m.T[:, None, None, :]                  # (K, 1, 1, M)
    xk = lanes.permute(1, 2, 0)[..., None]      # (K, J, L, 1)
    tail = None
    for k in range(S * chains, K):
        p = mk[k] * xk[k]
        tail = p if tail is None else tail + p
    if tail is not None:
        out = out + tail
    return out.permute(1, 2, 0).reshape(x.shape[:-2] + (M, J))


def chain_product(a: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``a @ mix`` as one chain of fused multiply-adds from zero (XLA's
    CPU dot of a traced (M, J) by (J, J) operand; the J = 3 loop below
    takes a constant ``mix``)."""
    a64 = a.to(_F64)
    m64 = mix.to(_F64)
    acc = torch.zeros(a.shape[:-1] + mix.shape[1:], dtype=torch.float32,
                      device=a.device)
    for k in range(mix.shape[0]):
        fma_(acc, a64[..., k, None], m64[k])
    return acc


def mix_chains(M: int, J: int) -> int:
    """The partial sums of XLA's CPU dot of an (M, J) operand by a constant
    J x J matrix, J != 3 (1: one chain of fused multiply-adds, as
    :func:`chain_product`; 2 or 4: :func:`basis_product`'s order).  XLA's
    runtime picks the order by shape; measured, not derived (jax 0.9, an
    x86-64 CPU with AVX2 and FMA; tests/test_torch_xla_order.py) at J =
    4-40 with M = 8-64, 68-128 in steps of 4 and 150-400 in steps of 50,
    and at J = 41-72, 96, 100, 128-130 and 256 with M = 8, 16, 32, 48,
    50-52, 64, 100, 200 and 400: one chain at J <= 2, at J = 5 for
    M <= 80, at J = 49-64, 128 and 256 for every M, and for M <= 50 at
    J = 9, 10, 13 and every J >= 17; past that two chains at J = 17-18,
    21-22, 25-32 and 96; four everywhere else.  Not reproduced: J = 5 at
    M = 11-12, 17-18 and 41-42 (the products summed unfused) and J = 256
    at M <= 50 (an order not found); a J not measured takes four."""
    if J <= 2 or (J == 5 and M <= 80) or 49 <= J <= 64 or J in (128, 256):
        return 1
    if M <= 50 and (J in (9, 10, 13) or J >= 17):
        return 1
    if J in (17, 18, 21, 22, 96) or 25 <= J <= 32:
        return 2
    return 4


def mix_product(a: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """``a @ mix`` for ``a`` (..., M, J) and a float32 J x J matrix, rounded
    as XLA's CPU code rounds the JAX package's product with the mixing
    matrix (or its transpose): see the module docstring and
    :func:`mix_chains`."""
    M, J = a.shape[-2:]
    if J != 3:
        n = mix_chains(M, J)
        if n == 1:
            return chain_product(a, mix)
        return basis_product(mix.T, a.transpose(-1, -2),
                             n).transpose(-1, -2)
    fused = chain_product(a, mix)
    p = [a[..., k, None] * mix[k] for k in range(3)]
    plain = (p[0] + p[1]) + p[2]
    rows = torch.arange(M, device=a.device)[:, None]
    cols = torch.arange(3, device=a.device)[None, :]
    take = (cols == 2) | (rows >= VECTOR * (M // VECTOR))
    return torch.where(take, fused, plain)


# ---------------------------------------------------------------------------
# The interpreted fused kernel's arithmetic on the CPU.
# ---------------------------------------------------------------------------


def interp_recip(s: torch.Tensor, newton: bool = True) -> torch.Tensor:
    """``1 / s`` as the JAX package's kernel forms it in the Pallas
    interpreter (pallas_step._Body.recip): ``pl.reciprocal(s,
    approx=True)`` runs there as the float32 quotient ``1 / bf16(s)``, of
    ``s`` rounded to bfloat16 (relative error up to 3.9e-3); with
    ``newton`` (``recip_newton``) one Newton step ``r (2 - s r)`` follows,
    whose ``2 - s r`` XLA contracts into one fused multiply-add.  This is
    the interpreter's reciprocal, not a TPU's hardware one, and it is
    less accurate than ``1 / s`` correctly rounded, which the port
    computes: with the step it equals that on about 6% of arguments
    (relative error up to 1.5e-5)."""
    r = 1.0 / s.to(torch.bfloat16).to(torch.float32)
    if not newton:
        return r
    two = torch.full_like(s, 2.0)
    return r * fma_(two, -s, r.to(_F64))


# glibc's float sine and cosine (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c
# and sincosf.h since glibc 2.28; XLA's CPU code calls sinf/cosf for each
# element): the argument in float64, reduced by the nearest multiple n of
# pi/2 when |x| >= 0.75 (one fused multiply-add with pi/2 in float64), the
# sine polynomial of the reduced argument for even n and the cosine one for
# odd n (cos: n + 1), each a few fused multiply-adds in float64, rounded to
# float32 once.  glibc picks its FMA build on a CPU with FMA.
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2 / pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")         # pi / 2
_COS = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
# Past this |x| glibc reduces with its 192-bit 2/pi table; not reproduced.
SINCOS_MAX = 120.0


def _fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a b + c`` in float64 with one rounding, as the FMA instruction:
    the product split exactly (Dekker), the sum's error kept (Knuth), the
    error terms added last.  It can differ from a true fused multiply-add
    only where that lands within one float64 ulp of a tie, which would
    move a float32 result rounded from it on about one argument in 2^28."""
    b = torch.as_tensor(b, dtype=_F64, device=a.device)
    c = torch.as_tensor(c, dtype=_F64, device=a.device)
    p = a * b
    ca, cb = 134217729.0 * a, 134217729.0 * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    v = s - p
    t = (p - (s - v)) + (c - v)
    return s + (t + e)


def _sincos(y: torch.Tensor, cos: bool) -> torch.Tensor:
    if bool((y.abs() >= SINCOS_MAX).any()):
        raise ValueError(f"sin/cos reproduced for |x| < {SINCOS_MAX} only")
    x = y.to(_F64)
    small = y.abs() < 0.75
    r = x * _HPI_INV
    n = (torch.trunc(r).to(torch.int64) + 0x800000) >> 24
    n = torch.where(small, torch.zeros_like(n), n)
    red = torch.where(small, x, _fma64(-n.to(_F64), _HPI, x))
    q = n & 3
    xs = torch.where((q == 1) | (q == 2), -red, red)
    x2 = red * red
    # Even: the sine polynomial; odd: the cosine one, negated for q >= 2.
    x3 = xs * x2
    s = _fma64(x3 * x2, _fma64(x2, _SIN[2], _SIN[1]),
               _fma64(x3, _SIN[0], xs))
    sg = torch.where((n & 2) != 0, -1.0, 1.0).to(_F64)
    c1 = _fma64(x2, sg * _COS[1], sg * _COS[0])
    c2 = _fma64(x2, sg * _COS[4], sg * _COS[3])
    c = _fma64(x2 * x2 * x2, c2, _fma64(x2 * x2, sg * _COS[2], c1))
    out = torch.where(((n + int(cos)) & 1) == 0, s, c).to(torch.float32)
    tiny = y.abs() < 2.0 ** -12
    return torch.where(tiny, torch.ones_like(y) if cos else y, out)


def sin(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``sin`` of a float32 tensor, |x| < SINCOS_MAX (glibc's
    ``sinf``; see above): correctly rounded on about 98.7% of arguments,
    torch's on about 95%, the two equal on about 95%."""
    return _sincos(x, cos=False)


def cos(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``cos`` of a float32 tensor, |x| < SINCOS_MAX (glibc's
    ``cosf``)."""
    return _sincos(x, cos=True)


def rsqrt_estimate(x: torch.Tensor) -> torch.Tensor:
    """The x86 ``vrsqrtps`` estimate of ``1 / sqrt(x)`` for positive normal
    float32 ``x``, as the Intel Xeon CPU it was measured on gives it (every
    mantissa at two exponents, bit for bit): the inverse square root of
    the middle of the interval of x's top 10 mantissa bits (per exponent
    parity), rounded to float32 and then to 12 significant bits (ties
    up), scaled by the exponent.  Other CPUs (AMD's) estimate otherwise."""
    bits = x.view(torch.int32).to(torch.int64)
    e = bits >> 23
    odd = (e & 1) == 1
    i = ((bits & 0x7FFFFF) >> 13).to(_F64)
    base = torch.where(odd, 1.0, 2.0).to(_F64)
    mid = base * (1.0 + (i + 0.5) / 1024.0)
    y = (1.0 / torch.sqrt(mid)).to(torch.float32).view(torch.int32)
    y = ((y.to(torch.int64) + 0x400) & ~0x7FF)
    shift = torch.div(-(e - torch.where(odd, 127, 128)), 2,
                      rounding_mode="floor")
    return (y + (shift << 23)).to(torch.int32).view(torch.float32)


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``rsqrt`` of positive normal float32 ``x``
    (``jax.lax.rsqrt``): :func:`rsqrt_estimate`, then two Newton steps
    ``y + (-0.5 y)((x y) y - 1)``, XLA contracting both of their sums into
    fused multiply-adds.  Correctly rounded on about 86% of arguments."""
    y = rsqrt_estimate(x)
    for _ in range(2):
        t = fma_(torch.full_like(x, -1.0), x * y, y.to(_F64))
        y = fma_(y.clone(), y * -0.5, t.to(_F64))
    return y


# XLA's CPU tree reduction: a sum over an axis longer than this is cut in
# windows of this many rows.
TREE_WINDOW = 32


def _chain_rows(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(0)`` as XLA's CPU code sums a float32 tensor over its leading
    axis (``jnp.sum(x, axis=0)``; the kernel's sums over T): up to
    TREE_WINDOW rows one chain ``((0 + x_0) + x_1) + ...``; more are padded
    with zeros, half of the padding in front (the smaller half when it is
    odd), to whole windows of TREE_WINDOW rows, each window summed as a
    chain and the window sums summed again by this rule.  Measured at n =
    32-5,000 rows (64 lanes) and n = 200 at 1 and 16 lanes."""
    n = x.shape[0]
    if n <= TREE_WINDOW:
        return _chain_rows(x)
    w = -(-n // TREE_WINDOW)
    pad = w * TREE_WINDOW - n
    zeros = torch.zeros((1,) + x.shape[1:], dtype=x.dtype, device=x.device)
    xp = torch.cat([zeros.expand((pad // 2,) + x.shape[1:]), x,
                    zeros.expand((pad - pad // 2,) + x.shape[1:])])
    parts = _chain_rows(xp.reshape((w, TREE_WINDOW) + x.shape[1:])
                        .transpose(0, 1))
    return tree_sum(parts)


# The tile widths N (lanes, the dot's columns) at which XLA's CPU runtime dot
# of an (M, K) basis matrix by a tile (K, N) is one chain of fused
# multiply-adds over k; at 2 <= N <= 16 (and 17-24, 40, 48 for K >= 100) it
# is :func:`basis_product`'s four chains.  Measured at K = 50, 100, 200, 400.
CHAIN_TILES = (56, 63, 64, 128)
SPLIT_TILES = tuple(range(2, 17))


def lane_product(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` for a float32 basis matrix ``m`` (M, K) and a tile of lanes
    ``x`` (..., K, N), rounded as XLA's CPU runtime dot rounds it at N
    columns: one chain of fused multiply-adds from zero over k ascending
    at N in CHAIN_TILES (the fused kernel's tiles of 64 and 128 lanes;
    ``torch.matmul`` on the CPU blocks K = 400 in two), the four chains
    of :func:`basis_product` at N in SPLIT_TILES.  Other N are refused:
    their order is not measured."""
    N = x.shape[-1]
    if N in SPLIT_TILES:
        return basis_product(m, x)
    if N not in CHAIN_TILES:
        raise ValueError(f"XLA's dot order is not measured at {N} columns")
    m64 = m.to(_F64)
    x64 = x.to(_F64)
    acc = torch.zeros(x.shape[:-2] + (m.shape[0], N), dtype=torch.float32,
                      device=x.device)
    for k in range(m.shape[1]):
        fma_(acc, m64[:, k, None], x64[..., k, None, :])
    return acc


# XLA's CPU exp of float32: Cephes' expf, each step a fused multiply-add.
_EXP_LO = -87.3365478515625          # log(2^-126): below, 0 (flushed)
_EXP_HI = 88.72283935546875
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``exp`` of float32 ``x`` (``jnp.exp``): ``n = floor(x
    log2(e) + 1/2)``, ``a = x - n ln2`` with ln2 in two parts, Cephes'
    degree-5 polynomial ``e^a = 1 + a + a^2 p(a)``, scaled by ``2^n``;
    each sum with its product one fused multiply-add; 0 below
    log(2^-126).  JAX's bits on 400,000 arguments over [-87, 88] (correctly
    rounded on about 91% of them)."""
    f32 = torch.float32
    xc = x.clamp(_EXP_LO, _EXP_HI)

    def fma(a, b, c):
        return fma_(torch.as_tensor(c, dtype=f32).expand_as(xc).clone(),
                    a.to(_F64), torch.as_tensor(b, dtype=f32).to(_F64))

    n = torch.floor(fma(xc, 1.4426950408889634, 0.5))
    a = fma(-n, 0.693359375, xc)
    a = fma(-n, -2.12194440e-4, a)
    y = torch.full_like(xc, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = fma(y, a, c)
    y = fma(y, a * a, a) + 1.0
    out = (y.to(_F64) * torch.exp2(n.to(_F64))).to(f32)
    return torch.where(x < _EXP_LO, torch.zeros_like(out), out)
