"""The port's config and basis against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
import irm_motion_planning_tpu_torch as mt
from irm_motion_planning_tpu_torch.models import rkhs


@pytest.mark.parametrize("kw", [
    {},
    dict(inner_schedule=mp.REFERENCE_INNER_SCHEDULE_BLS, fixed_iters=True,
         max_inner_iteration=64, max_obstacles=11),
])
def test_config_matches_field_by_field(kw):
    assert dataclasses.asdict(mt.PlannerConfig(**kw)) == dataclasses.asdict(
        mp.PlannerConfig(**kw))


def test_reference_constants_match():
    assert mt.REFERENCE_INNER_SCHEDULE_BLS == mp.REFERENCE_INNER_SCHEDULE_BLS
    assert mt.REFERENCE_INNER_SCHEDULE_GD == mp.REFERENCE_INNER_SCHEDULE_GD
    assert mt.REFERENCE_FINAL_COST == mp.REFERENCE_FINAL_COST


@pytest.mark.parametrize("kw,match", [
    (dict(n_joints=2), "link_length"),
    (dict(max_outer_iteration=11), "gd_lr"),
    (dict(inner_schedule=(1, 2)), "inner_schedule"),
    (dict(inner_schedule=(0,) * 10), "inner_schedule"),
    (dict(ladder_eval="exactly"), "ladder_eval"),
])
def test_config_validation_matches(kw, match):
    for cls in (mp.PlannerConfig, mt.PlannerConfig):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_committed_export_is_bitwise_the_jax_basis():
    """The export carries JAX's basis across unchanged: every array
    bitwise, because a 1-ulp change of the ~1e15-conditioned Gram data
    moves the warm start by O(1)."""
    cfg = mp.PlannerConfig()
    ref = mp.make_basis(cfg)
    got = mt.make_basis(mt.PlannerConfig(), device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            err_msg=name)


def test_basis_from_numpy_roundtrip():
    ref = mp.make_basis(mp.PlannerConfig())
    got = mt.basis_from_numpy({k: np.asarray(getattr(ref, k))
                               for k in ref._fields}, device="cpu")
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))


@pytest.mark.parametrize("kw", [
    dict(n_timesteps=40), dict(rbf_variance=0.2), dict(mix_seed=1),
    dict(mix_scale=0.1),
])
def test_make_basis_refuses_other_configs(kw):
    """A config without a committed export (these were refused before the
    port built its own basis): make_basis builds it (build_basis, not the
    T=50 export), and it matches JAX's basis for the same config: t, c and
    mix exact, km within 1 ulp, dkm and kv within 2, mix_inv within 8
    float32 epsilons of its largest entry (tests/test_torch_basis_build.py
    says why)."""
    cfg = mt.PlannerConfig(**kw)
    got = mt.make_basis(cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in
               zip(got, rkhs.build_basis(cfg, device="cpu")))
    ref = mp.make_basis(mp.PlannerConfig(**kw))
    for name, tol in (("t", 0), ("c", 0), ("mix", 0), ("km", 1), ("dkm", 2),
                      ("kv", 2)):
        assert _ulps(getattr(got, name).numpy(),
                     np.asarray(getattr(ref, name))) <= tol, name
    mi = np.asarray(ref.mix_inv)
    assert (np.abs(got.mix_inv.numpy() - mi).max()
            <= 8 * np.finfo(np.float32).eps * np.abs(mi).max())


def _ulps(a, b) -> int:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(ordered(a) - ordered(b)).max())


def test_evaluate_matches_jax():
    """The warm start through evaluate.  Tolerance: the basis product
    cancels O(1e3) coefficients to O(1), so another summation order moves
    the result: measured 1.9e-3 on traj and 1.8e-2 on vel (the derivative
    kernel's larger entries) against JAX's CPU dot."""
    cfg = mp.PlannerConfig()
    jb = mp.make_basis(cfg)
    tb = mt.make_basis(mt.PlannerConfig(), device="cpu")
    scn = mp.reference_scenario(cfg)
    alpha = np.asarray(mp.init_alpha(cfg, jb, scn.start, scn.goal))
    jt, jv = (np.asarray(x) for x in mp.evaluate(cfg, jb, alpha))
    tt, tv = mt.evaluate(mt.PlannerConfig(), tb, torch.tensor(alpha))
    np.testing.assert_allclose(tt.numpy(), jt, atol=2e-2)
    np.testing.assert_allclose(tv.numpy(), jv, atol=5e-2)
    # The smoothstep warm start hits the endpoints (measured 2e-4).
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(scn.start), atol=2e-3)
    np.testing.assert_allclose(tt[-1].numpy(), np.asarray(scn.goal), atol=2e-3)
