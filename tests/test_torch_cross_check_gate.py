"""The card-vs-CPU gradient gate of ``chip_smoke.py`` (``cross_check_gate``)
on tensors made here: an L1 sign flip of the colour loss inside the tie
(both residuals within L1_TIE) is evaluated again with the same
subgradient on both sides and passes when that evaluation agrees; a flip
outside the tie, or a gradient fault of 2% on one leaf, still fails."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

R = 64


def _grads(rng, rgb_off=0.0, sdf_off=0.0):
    """{leaf: (cpu, card)} with the card's colour-path leaf off by ``rgb_off``
    and its SDF leaf off by ``sdf_off`` (relative L2)."""
    out = {}
    for name, off in (("/rgb/mlp/0/w", rgb_off), ("/sdf/mlp/0/w", sdf_off),
                      ("/variance/variance", 0.0)):
        g = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
        d = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32))
        out[name] = (g, g + d * (off * g.norm() / d.norm()))
    out["/frozen"] = (None, None)
    return out


def _evaluation(res_c, res_g, grads, seed=0):
    rng = np.random.default_rng(seed)
    hit = torch.ones((R, 1), dtype=torch.bool)
    hit[::9] = False
    loss = float(rng.uniform(0.1, 0.2))
    return {"loss_cpu": loss, "loss_card": loss * (1 + 1e-6), "grads": grads,
            "res_cpu": res_c, "res_card": res_g, "hit_cpu": hit, "hit_card": hit.clone(),
            "extra": {"valid_samples": 1234}}


def _residuals(rng):
    res = torch.from_numpy(rng.uniform(0.01, 0.2, (R, 3)).astype(np.float32))
    res = res * torch.from_numpy(rng.choice([-1.0, 1.0], (R, 3)).astype(np.float32))
    return res, res.clone()


class _Evaluations:
    """``evaluate`` for the gate: the first evaluation, then the one after
    the tie's shift; records the shifts it was given."""

    def __init__(self, first, second=None):
        self.first, self.second, self.shifts = first, second, []

    def __call__(self, gt_shift):
        self.shifts.append(gt_shift)
        if gt_shift is None:
            return self.first
        assert self.second is not None, "the gate evaluated again without a tie"
        ev = dict(self.second)
        ev["res_cpu"] = ev["res_cpu"] + gt_shift
        ev["res_card"] = ev["res_card"] + gt_shift
        return ev


def _tied_flip(res_c, res_g):
    """One channel of a counted ray at a tie: +3e-7 on the CPU, -2e-7 on the card."""
    res_c[5, 1], res_g[5, 1] = 3e-7, -2e-7
    return (5, 1)


def test_a_flip_inside_the_tie_with_otherwise_equal_gradients_passes():
    rng = np.random.default_rng(0)
    res_c, res_g = _residuals(rng)
    ch = _tied_flip(res_c, res_g)
    # the flip moves the colour path's gradients by 3% in the first evaluation;
    # with the same subgradient on both sides they agree
    evals = _Evaluations(_evaluation(res_c, res_g, _grads(rng, rgb_off=0.03)),
                         _evaluation(res_c, res_g, _grads(rng)))
    out = cs.cross_check_gate("gate_test", evals)
    assert out["l1_sign_flips"] == out["l1_sign_flips_within_tie"] == 1
    assert out["grad_rel_l2_err"]["/rgb/mlp/0/w"] > cs.TOL_GRAD_CROSS
    assert out["tie_aligned"]["l1_sign_flips"] == 0
    assert max(out["tie_aligned"]["grad_rel_l2_err"].values()) < 1e-6
    assert len(evals.shifts) == 2 and evals.shifts[0] is None
    shift = evals.shifts[1]
    assert shift[ch] == cs.L1_TIE_SHIFT  # toward the CPU's sign (+)
    assert int((shift != 0).sum()) == 1


def test_a_flip_outside_the_tie_fails():
    rng = np.random.default_rng(1)
    res_c, res_g = _residuals(rng)
    res_c[7, 2], res_g[7, 2] = 4e-6, -3e-6  # beyond L1_TIE on both sides
    evals = _Evaluations(_evaluation(res_c, res_g, _grads(rng, rgb_off=0.03)))
    with pytest.raises(SystemExit):
        cs.cross_check_gate("gate_test", evals)
    assert evals.shifts == [None]


def test_a_flip_outside_the_tie_beside_a_tied_one_fails():
    rng = np.random.default_rng(2)
    res_c, res_g = _residuals(rng)
    _tied_flip(res_c, res_g)
    res_c[10, 0], res_g[10, 0] = -2e-6, 5e-7  # the CPU's residual is past the tie
    evals = _Evaluations(_evaluation(res_c, res_g, _grads(rng, rgb_off=0.03)))
    with pytest.raises(SystemExit):
        cs.cross_check_gate("gate_test", evals)
    assert evals.shifts == [None]


@pytest.mark.parametrize("tied_flip", [False, True])
def test_a_planted_gradient_fault_fails(tied_flip):
    rng = np.random.default_rng(3)
    res_c, res_g = _residuals(rng)
    if tied_flip:
        _tied_flip(res_c, res_g)
        evals = _Evaluations(_evaluation(res_c, res_g, _grads(rng, rgb_off=0.03, sdf_off=0.02)),
                             _evaluation(res_c, res_g, _grads(rng, sdf_off=0.02)))
    else:
        evals = _Evaluations(_evaluation(res_c, res_g, _grads(rng, sdf_off=0.02)))
    with pytest.raises(SystemExit):
        cs.cross_check_gate("gate_test", evals)
    assert len(evals.shifts) == (2 if tied_flip else 1)


def test_equal_evaluations_pass_and_a_non_finite_card_gradient_fails():
    rng = np.random.default_rng(4)
    res_c, res_g = _residuals(rng)
    grads = _grads(rng)
    out = cs.cross_check_gate("gate_test", _Evaluations(_evaluation(res_c, res_g, grads)))
    assert out["l1_sign_flips"] == 0 and out["tie_aligned"] is None
    cpu, card = grads["/sdf/mlp/0/w"]
    card = card.clone()
    card[0, 0] = float("nan")
    grads["/sdf/mlp/0/w"] = (cpu, card)
    with pytest.raises(SystemExit):
        cs.cross_check_gate("gate_test", _Evaluations(_evaluation(res_c, res_g, grads)),
                            gate=False)
