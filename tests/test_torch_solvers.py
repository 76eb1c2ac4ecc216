"""The port's multistep flow-matching solvers (`models/schedulers/fm_solvers.py`)
against the JAX package's over whole schedules, on the CPU in float32.

Each step takes the same numpy flow prediction on both sides (a smooth
function of the current sample plus a per-step draw), so every sample of
the trajectory and the final state are compared. Tolerance 1e-5 (absolute
and relative): the two frameworks evaluate the same float32 expressions with
the same host coefficients, up to float32 reassociation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.models.schedulers import fm_solvers as jfm
from inferix_tpu_torch.models.schedulers import fm_solvers as tfm

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = (2, 3, 4, 4, 16)


def _run(jsolver, tsolver, steps, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jstate, tstate = jsolver.init_state(SHAPE), tsolver.init_state(SHAPE)
    for i in range(steps):
        draw = rng.standard_normal(SHAPE).astype(np.float32)
        # the same flow for both: computed from the JAX sample in numpy
        flow = (0.8 * np.asarray(jx) + 0.3 * draw).astype(np.float32)
        jx, jstate = jsolver.step(jnp.asarray(flow), i, jx, jstate)
        tx, tstate = tsolver.step(torch.from_numpy(flow), i, tx, tstate)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), err_msg=f"step {i}", **TOL)
    return jstate, tstate


def test_dpm_solver_schedule():
    j = jfm.FlowDPMSolverMultistep.create(20, shift=5.0)
    t = tfm.FlowDPMSolverMultistep.create(20, shift=5.0)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    jstate, tstate = _run(j, t, 20, 0)
    np.testing.assert_allclose(tstate.prev_d.numpy(), np.asarray(jstate.prev_d), **TOL)
    assert bool(tstate.prev_valid) and bool(jstate.prev_valid)
    np.testing.assert_allclose(float(tstate.prev_h), float(jstate.prev_h), rtol=1e-6)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("variant", ["bh1", "bh2"])
def test_unipc_schedule(order, variant):
    """UniPC over a whole schedule at orders 1-3: the warm-up steps, the
    full-order middle and the lower-order final steps."""
    j = jfm.FlowUniPCMultistep.create(12, shift=5.0, solver_order=order, solver_type=variant)
    t = tfm.FlowUniPCMultistep.create(12, shift=5.0, solver_order=order, solver_type=variant)
    np.testing.assert_array_equal(t.sigmas, j.sigmas)
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    assert [t._order_pred(i) for i in range(12)] == [j._order_pred(i) for i in range(12)]
    jstate, tstate = _run(j, t, 12, order)
    np.testing.assert_allclose(tstate.m_hist.numpy(), np.asarray(jstate.m_hist), **TOL)
    np.testing.assert_allclose(tstate.last_sample.numpy(), np.asarray(jstate.last_sample),
                               **TOL)


@pytest.mark.parametrize("order", [2, 3])
def test_unipc_coeffs(order):
    rks = np.asarray([-0.7, -0.3, 1.0][3 - order:])
    for hh in (-0.05, -0.4, -1.3):
        for variant in ("bh1", "bh2"):
            for a, b in zip(tfm._unipc_coeffs(hh, rks, order, variant),
                            jfm._unipc_coeffs(hh, rks, order, variant)):
                np.testing.assert_array_equal(a, b)


def test_bf16_sample_keeps_its_dtype():
    """A bf16 sample comes back bf16 (the tensor math runs in float32)."""
    t = tfm.FlowUniPCMultistep.create(4)
    x = torch.randn(SHAPE, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    out, state = t.step(x, 0, x, t.init_state(SHAPE))
    assert out.dtype == torch.bfloat16 and state.m_hist.dtype == torch.float32
