"""The port's config and basis against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import irm_motion_planning_tpu as mp
import irm_motion_planning_tpu_torch as mt


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
    with pytest.raises(ValueError, match="export_torch_basis"):
        mt.make_basis(mt.PlannerConfig(**kw), device="cpu")


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
