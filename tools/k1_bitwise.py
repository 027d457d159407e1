"""Hold the kernels of two checkouts to each other bit for bit.

    python tools/k1_bitwise.py dump OUT.pt      # from a checkout's root
    python tools/k1_bitwise.py compare A.pt B.pt

``dump`` builds the kernels of the checkout it runs in (the package is
imported from the current directory) and saves, for each program of K1/K2
(the solvers' and ladders', bls, gd, bls_exact, and the linearized
ladder's kernel tiers, bls_ultra and bls_bf16), K1's whole solve at the
bench schedule and K2's one round (a quarter of the lanes fulfilled) on
16,384 random scenes (seed 5) at T=50 (the resident body, its specialised
instantiation) and on 1,024 random scenes at T=200 (the streamed body);
and on the same scenes the per-step kernels: K5's evaluation and K6's
forward evaluation at the warm start, and from K5's state one step of K3
(both ladder tiers) and of K4 (a quarter of the lanes frozen).  The same
for JAX's 5-link arm (J = 5, its own library) with the programs bls and
gd, on 4,096 scenes at T=50 and 512 at T=200 (keys ``J=5``).
``compare`` says for each whether every output field is equal bit for bit,
and exits non-zero if one is not.  Two checkouts on one card: dump in
each, then compare.  Needs a CUDA card for ``dump``.
"""

import os
import sys

import torch

PROGRAMS = ("bls", "gd", "bls_exact", "bls_ultra", "bls_bf16")
# (J, link lengths, programs, (T, lanes) pairs): the reference arm, then
# JAX's 5-link test arm.
CASES = ((3, None, PROGRAMS, ((50, 16384), (200, 1024))),
         (5, (1.0, 0.8, 0.6, 0.4, 0.2), ("bls", "gd"),
          ((50, 4096), (200, 512))))


def dump(out):
    sys.path.insert(0, os.getcwd())
    import irm_motion_planning_tpu_torch as mt
    from irm_motion_planning_tpu_torch import bench
    from irm_motion_planning_tpu_torch.ops import fused_solve as fs
    from irm_motion_planning_tpu_torch.ops import step_kernels as sk
    from irm_motion_planning_tpu_torch.solvers import fleet

    dev = torch.device("cuda", 0)
    res = {}
    cases = [(J, links, prog, T, batch)
             for J, links, programs, sizes in CASES
             for T, batch in sizes for prog in programs]
    for J, links, prog, T, batch in cases:
        tag = f"T={T}" + ("" if J == 3 else f" J={J}")
        solver, ladder, tier = fs.program_call(prog)
        cfg = bench.bench_config(solver=solver, n_timesteps=T,
                                 ladder_eval=ladder)
        if links:
            cfg = cfg.replace(n_joints=J, link_length=links)
        basis = mt.make_basis(cfg, device=dev)
        scns = mt.random_scenarios(cfg, torch.Generator().manual_seed(5),
                                   batch, device=dev)
        args = fleet.fused_args(cfg, basis, scns)
        k1 = fs.fused_solve(*args, solver=solver, **tier)
        g = torch.Generator().manual_seed(0)
        ful = (torch.rand((1, batch), generator=g) < 0.25).float().to(dev)
        lr0 = torch.full_like(ful, fs.round_lr(cfg, 0, solver))
        k2 = fs.fused_round(*args[:7], ful, lr0, 4, *args[7:],
                            solver=solver, **tier)
        res[f"K1 {prog} {tag}"] = [x.cpu() for x in k1]
        res[f"K2 {prog} {tag}"] = [x.cpu() for x in k2]
        _, kv, kvt, mix, a0, lsg, ljl, start, goal, ox, oy, ow = args
        lanes = (lsg, ljl, start, goal, ox, oy, ow)
        if tier:
            continue
        if prog == "bls":
            res[f"K5 {tag}"] = [x.cpu() for x in sk.cost_grad_eval(
                cfg, kv, kvt, mix, a0, *lanes)]
            res[f"K6 {tag}"] = [x.cpu() for x in sk.forward_eval(
                cfg, kv, mix, a0)]
        ev = sk.cost_grad_eval(cfg, kv, kvt, mix, a0, *lanes)
        step = sk.gd_inner_step if prog == "gd" else sk.bls_inner_step
        lr = torch.full_like(lsg, fs.round_lr(cfg, 0, solver))
        res[f"{'K4' if prog == 'gd' else 'K3'} {prog} {tag}"] = [
            x.cpu() for x in step(cfg, kv, kvt, mix, a0, *ev[1:], ev.loss,
                                  lr, ful, *lanes)]
    torch.save(res, out)
    print(f"dumped {sorted(res)} to {out}")


def compare(a, b):
    x, y = torch.load(a), torch.load(b)
    ok = sorted(x) == sorted(y)
    for key in sorted(x):
        same = key in y and all(torch.equal(p, q) for p, q in zip(x[key],
                                                                  y[key]))
        ok = ok and same
        print(f"{key}: bitwise equal {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["dump"] and len(sys.argv) == 3:
        dump(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
