"""The plain K1's linearized carry program in the arithmetic of the JAX
package's fused kernel as Pallas's interpreter runs it on the CPU: a
diagnostic of the CPU tooling (tools/compare_converged.py ``--replica``,
tests/test_torch_carry_replica.py), not a path of the port, which imports
nothing of it.

``fused_solve``'s plain versions round as the CUDA kernels do (and as the
port's tests hold them to JAX: within measured tolerances).  The JAX
package's fused kernel, interpreted (``interpret=True``, the only way it
runs on a CPU), is compiled by XLA into the CPU's arithmetic, which differs
from the port's in a few named places, each a *piece* here.  Inside
:class:`replica` the plain versions take the pieces named, by swapping
``fused_solve``'s helpers (the tools and tests that use it run in a
process of their own or restore the helpers on exit):

* ``recip``: the obstacle field's reciprocal, ``1 / bf16(s)`` and one
  Newton step (``xla_order.interp_recip``), where the port divides;
* ``sincos``: the FK's sin and cos, glibc's (``xla_order.sin``/``cos``;
  glibc 2.28 or later, its FMA build);
* ``rsqrt``: the direction's ``1 / |g|``, the CPU's estimate and two
  Newton steps (``xla_order.rsqrt``: the estimate's table of the Intel
  Xeon it was measured on), where the port takes a square root and
  divides;
* ``tsums``: every sum over T (the loss's, the direction's), XLA's tree
  of windows (``xla_order.tree_sum``), where the port chains;
* ``pullback`` and ``forward``: the gradient's pull-back and the forward
  product, XLA's runtime dot at the tile's width
  (``xla_order.lane_product``);
* ``contract``: the products XLA contracts into fused multiply-adds
  (:data:`CONTRACTED`, one set per expression family, and the evaluation's
  sums as XLA fuses them: :func:`fk_ee`, :func:`cost_grad_from_traj`,
  :func:`constraints_ok`), but the accepted alpha's;
* ``alpha``: the accepted alpha ``a_fac alpha - lr n_grad`` rounded once
  (one fused multiply-add), where the carry program rounds it twice at
  J = 3 (``fused_solve.two_roundings``; the port's other programs, and the
  carry program at every other J, round once);
* ``init``: the fleet's warm start (``solvers.fleet.fleet_init_alpha``),
  whose product with ``mix_inv`` XLA forms as one chain of fused
  multiply-adds (torch's ``einsum`` picks its order by the scenes' layout).

``replica(ALL)`` is the interpreted kernel's whole floating-point path
(tools/compare_converged.py ``--replica all``;
tests/test_torch_carry_replica.py holds it to the kernel bit for bit).
Two pieces are the host's, not XLA's: on a CPU whose ``rsqrt`` estimate
or a libm whose ``sinf``/``cosf`` differs from those written out, the
replica is not the kernel bit for bit (the tests check the host first).
"""

from __future__ import annotations

import torch

from irm_motion_planning_tpu_torch.models import xla_order
from irm_motion_planning_tpu_torch.ops import fused_solve as fs
from irm_motion_planning_tpu_torch.solvers import fleet


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _mix_once(terms):
    """The mix combine as XLA contracts it: fma(x0, m0, x1 m1), then each
    later term fused into the sum."""
    (x0, m0), (x1, m1) = terms[:2]
    acc = fs.fma(x0, m0, x1 * m1)
    for x, m in terms[2:]:
        acc = fs.fma(x, m, acc)
    return acc


# The carry program's expressions XLA contracts on the CPU, by family, each
# a list of the fused_solve helpers that form them with their one-rounding
# replacements (a b + c d as fma(a, b, c d), acc + a b as fma(a, b, acc):
# PERF.md section 7).
CONTRACTED = {
    "dir": [("carry_direction",
             lambda lam, x, g: fs.fma(_f32(lam), x, g))],
    "cand": [("rung_point", lambda x, lr, d: fs.fma(-lr, d, x))],
    "nt": [("accepted_point", lambda x, lr, d: fs.fma(-lr, d, x))],
    "alpha": [("two_roundings", fs.fma)],
    "mix": [("mix_combine", _mix_once)],
    "field": [("field_q", lambda ox, oy: 0.5 + 0.5 * fs.fma(ox, ox, oy * oy)),
              ("field_h", lambda ex, ey: 0.5 * fs.fma(ex, ex, ey * ey)),
              ("field_dist", lambda h, q, ox, ex, oy, ey:
               (h + q) - fs.fma(ox, ex, oy * ey)),
              ("field_sum", _mix_once),
              ("field_acc", _mix_once),
              ("field_grad", lambda co, e, csum: fs.fma(-e, csum, co))],
    "sums": [("sum_pair", lambda a, b, c, d:
              fs.fma(_f32(a), _f32(b), _f32(c) * _f32(d))),
             ("sum_add", lambda acc, a, b: fs.fma(_f32(a), _f32(b), acc))],
}


# The evaluation as XLA fuses and contracts it: where a product feeds a sum
# in one fused loop and nothing else, the two are one fused multiply-add.
# In the FK the per-link terms L_j cos(c_j) are consumed where they are
# formed (the end effector, the Jacobian), except the tangent planes the
# ladder carries, which are stored rounded.


def _chain_once(terms):
    """``sum_j a_j b_j`` as XLA contracts it (one term: the product)."""
    if len(terms) == 1:
        return terms[0][0] * terms[0][1]
    return _mix_once(terms)


def fk_ee(c, traj):
    """fused_solve.fk_ee with the end effector's sums contracted."""
    J = traj.shape[0]
    ang = [traj[0]]
    for j in range(1, J):
        ang.append(ang[-1] + traj[j])
    link = [_f32(x) for x in c.link]
    cos = [fs.fk_cos(a) for a in ang]
    sin = [fs.fk_sin(a) for a in ang]
    px = torch.stack([link[j] * cos[j] for j in range(J)])
    py = torch.stack([link[j] * sin[j] for j in range(J)])
    ee_x = _chain_once([(cos[j], link[j]) for j in range(J)])
    ee_y = _chain_once([(sin[j], link[j]) for j in range(J)])
    return ee_x, ee_y, px, py, (link, cos, sin)


def _jacobian(J, px, py, fresh):
    """The Jacobian's suffix sums: of the carried tangent planes (rounded,
    added), or of a fresh FK's terms, each later term fused into the sum."""
    jac_x, jac_y = [None] * J, [None] * J
    if fresh is None:
        accx = torch.zeros_like(px[0])
        accy = torch.zeros_like(px[0])
        for j in range(J - 1, -1, -1):
            accx = accx + (-py[j])
            accy = accy + px[j]
            jac_x[j], jac_y[j] = accx, accy
        return jac_x, jac_y
    link, cos, sin = fresh
    accx, accy = -py[J - 1], px[J - 1]
    jac_x[J - 1], jac_y[J - 1] = accx, accy
    for j in range(J - 2, -1, -1):
        accx = fs.fma(-sin[j], link[j], accx)
        accy = fs.fma(cos[j], link[j], accy)
        jac_x[j], jac_y[j] = accx, accy
    return jac_x, jac_y


def cost_grad_from_traj(cfg, c, kvt, mix, nt, nv, start, goal, obs, lam_sg,
                        lam_jl, fk=None, skip_loss=False):
    """fused_solve.cost_grad_from_traj as XLA forms it: the field's
    accumulators co{x,y} and gradient contracted, its csum the plain sum of
    the rounded c_o (they feed co{x,y} too), the Jacobian from a fresh FK
    contracted, the pulled terms ``wgx jac_x + wgy jac_y + lam_sg sgp +
    lam_jl jp`` and ``lam_sg sgv + lam_jl jv`` contracted."""
    J, T = nt.shape[0], nt.shape[1]
    lam_max = cfg.lambda_max_cost
    ox, oy, q, ow8 = obs
    fresh = None
    if fk is None:
        ee_x, ee_y, px, py, fresh = fk_ee(c, nt)
    else:
        px, py = fk
        ee_x, ee_y = px[0], py[0]
        for j in range(1, J):
            ee_x = ee_x + px[j]
            ee_y = ee_y + py[j]
    h = fs.field_h(ee_x, ee_y)
    inv = [fs.recip(fs.field_dist(h, q[o], ox[o], ee_x, oy[o], ee_y))
           for o in range(ox.shape[0])]
    winv = [ow8[o] * r for o, r in enumerate(inv)]
    coef = [w * r for w, r in zip(winv, inv)]
    cost_v = fs.field_sum([(ow8[o], r) for o, r in enumerate(inv)])
    csum = coef[0]
    for cf in coef[1:]:
        csum = csum + cf
    cox = _chain_once([(cf, ox[o]) for o, cf in enumerate(coef)])
    coy = _chain_once([(cf, oy[o]) for o, cf in enumerate(coef)])
    gx = fs.field_grad(cox, ee_x, csum)
    gy = fs.field_grad(coy, ee_y, csum)
    rows = torch.arange(T, device=nt.device)[:, None]
    first_max = fs.first_argmax(cost_v)[None]
    wblend = lam_max * (rows == first_max).to(torch.float32) + (
        (1.0 - lam_max) / T)
    wgx = wblend * gx
    wgy = wblend * gy
    jac_x, jac_y = _jacobian(J, px, py, fresh)
    loss = None if skip_loss else fs.scalar_cost(
        cfg, c, nt, nv, cost_v, start, goal, lam_sg, lam_jl)
    stacked = []
    for j in range(J):
        # The last joint's jac_x is a negated term, which LLVM moves into
        # the sum: wgy jac_y - wgx |jac_x|, the first product fused.
        toc_g = (fs.fma(wgx, jac_x[j], wgy * jac_y[j]) if j < J - 1
                 else fs.fma(wgy, jac_y[j], wgx * jac_x[j]))
        sgp = torch.zeros_like(ee_x)
        sgp[0] = nt[j, 0] - start[j]
        sgp[T - 1] = nt[j, T - 1] - goal[j]
        sgv = torch.zeros_like(ee_x)
        sgv[0] = nv[j, 0]
        sgv[T - 1] = nv[j, T - 1]
        jp = (nt[j] - c.mean_jp) * c.inv_std2_T
        jv = nv[j] * c.inv_vmax2_T
        if cfg.constraint_violating_dependant_loss:
            jp = torch.where(fs._pos_mask(cfg, nt[j]), jp, 0.0)
            jv = torch.where(fs._vel_mask(cfg, nv[j]), jv, 0.0)
        stacked.append(torch.cat([
            fs.fma(lam_jl, jp, fs.fma(lam_sg, sgp, toc_g)),
            fs.fma(lam_sg, sgv, lam_jl * jv)]))
    pulled = fs.pullback_product(kvt, torch.stack(stacked))
    grad = [fs.mix_combine([(pulled[i], mix[j, i]) for i in range(J)])
            for j in range(J)]
    return loss, torch.stack(grad), px, py


def constraints_ok(cfg, traj, vel, start, goal):
    """fused_solve.constraints_ok with the squared distances' sums over
    the joints contracted."""
    T = traj.shape[1]

    def sq(d):
        return _chain_once([(d[j], d[j]) for j in range(d.shape[0])])

    pos_ok = (torch.sqrt(sq(traj[:, 0] - start)) < cfg.eps_position) & (
        torch.sqrt(sq(traj[:, T - 1] - goal)) < cfg.eps_position)
    vel_ok = (torch.sqrt(sq(vel[:, 0])) < cfg.eps_velocity) & (
        torch.sqrt(sq(vel[:, T - 1])) < cfg.eps_velocity)
    box_ok = (traj.amax(dim=(0, 1)) <= cfg.max_joint_position) & (
        traj.amin(dim=(0, 1)) >= cfg.min_joint_position)
    vbox_ok = vel.abs().amax(dim=(0, 1)) <= cfg.max_joint_velocity
    return pos_ok & vel_ok & box_ok & vbox_ok


def fleet_init_alpha(cfg, basis, scn):
    """solvers.fleet.fleet_init_alpha as the JAX package forms it op by
    op: ``start mix_inv`` and ``(goal - start) mix_inv`` each one chain of
    fused multiply-adds over the joints, the two outer products rounded and
    added."""
    sm = xla_order.chain_product(scn.start.T, basis.mix_inv).T
    dm = xla_order.chain_product((scn.goal - scn.start).T, basis.mix_inv).T
    return (basis.init_u[:, None, None] * sm[None]
            + basis.init_w[:, None, None] * dm[None])


def _tree_sums(planes):
    return torch.stack([xla_order.tree_sum(p) for p in planes])


# The pieces, each a list of (fused_solve helper, replacement) pairs, or of
# (module, name, replacement) for a helper elsewhere.
PIECES = {
    "recip": [("recip", lambda s: xla_order.interp_recip(s, True))],
    "sincos": [("fk_cos", xla_order.cos), ("fk_sin", xla_order.sin)],
    "rsqrt": [("inv_sqrt", xla_order.rsqrt)],
    "tsums": [("t_sums", _tree_sums),
              ("step_sums", lambda p: _tree_sums(list(p)))],
    "pullback": [("pullback_product", xla_order.lane_product)],
    "forward": [("forward_product", xla_order.lane_product)],
    "contract": [pair for k, pairs in CONTRACTED.items() if k != "alpha"
                 for pair in pairs] + [
        ("fk_ee", lambda c, traj: fk_ee(c, traj)[:4]),
        ("cost_grad_from_traj", cost_grad_from_traj),
        ("constraints_ok", constraints_ok),
        ("limit_sum",
         lambda terms: _chain_once([(a, _f32(b)) for a, b in terms])),
        ("armijo_bound", lambda loss, cf, an: fs.fma(-cf, an, loss)),
        ("decay_factor", lambda lam, lr: fs.fma(-lr, _f32(lam), _f32(1.0))),
    ],
    "alpha": CONTRACTED["alpha"],
    "init": [(fleet, "fleet_init_alpha", fleet_init_alpha)],
}
ALL = tuple(PIECES)


def parse(spec: str) -> tuple:
    """A comma list of PIECES (``all``: every piece; ``all-x``: every piece
    but x; ``none``: no piece, the port as shipped) -> the pieces' names."""
    names = []
    for k in (k for k in spec.split(",") if k):
        if k == "none":
            continue
        if k == "all":
            names += ALL
        elif k.startswith("all-"):
            names += [p for p in ALL if p != k[4:]]
        else:
            names.append(k)
    bad = [k for k in names if k not in PIECES]
    if bad:
        raise ValueError(f"replica pieces are {sorted(PIECES)}, got {bad}")
    return tuple(dict.fromkeys(names))


class replica:
    """The context in which fused_solve's plain versions take the pieces
    ``names`` (see the module docstring); ``swaps``: more (name, function)
    pairs of fused_solve to replace."""

    def __init__(self, names=None, swaps=()):
        self.swaps = [(fs,) + pair if len(pair) == 2 else pair
                      for k in (ALL if names is None else names)
                      for pair in PIECES[k]]
        self.swaps += [(fs,) + pair for pair in swaps]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.swaps]
        for mod, name, fn in self.swaps:
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
