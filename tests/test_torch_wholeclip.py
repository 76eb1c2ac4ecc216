"""The port's three whole-clip DiT forwards
(`inferix_tpu_torch.models.wan.causal_dit`: `dit_forward_bidirectional`,
`dit_forward_block_causal`, `dit_forward_teacher_forcing`) against the JAX
functions at tiny_test_config sizes in float32 on the CPU, the same
parameters and inputs (numpy seeds) on both sides, held to 1e-5; and the
port's versions of the property tests of tests/test_semi_ar_loop.py
(`:130`, `:178`, `:204`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferix_tpu.core.config import tiny_test_config as jax_tiny_config
from inferix_tpu.models.wan import causal_dit as jdit
from inferix_tpu.ops.rope import build_rope_tables as jax_rope_tables
from inferix_tpu_torch.core.config import tiny_test_config
from inferix_tpu_torch.models.wan import causal_dit as tdit
from inferix_tpu_torch.ops.rope import build_rope_tables
from inferix_tpu_torch.utils.params import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_tiny_config().model, tiny_test_config().model
    jp = jdit.init_params(jax.random.key(0), jcfg, dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    ctx = np.random.default_rng(0).standard_normal(
        (1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    jx = jdit.precompute_crossattn_cache(jp, jcfg, jnp.asarray(ctx))
    tx = tdit.precompute_crossattn_cache(tp, tcfg, torch.from_numpy(ctx))
    jt = jax_rope_tables(jcfg.head_dim, 64)
    tt = build_rope_tables(tcfg.head_dim, 64, device="cpu")
    return (jcfg, jp, jx, jt), (tcfg, tp, tx, tt)


def _inputs(seed, frames, t_val):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, frames, 8, 8, 16)).astype(np.float32)
    return x, np.full((1, frames), t_val, np.float32)


def _run(models, name, *arrays, **kw):
    (jcfg, jp, jx, jt), (tcfg, tp, tx, tt) = models
    n = len(arrays) - 1  # the last array is t
    want = getattr(jdit, name)(jp, jcfg, jt, *map(jnp.asarray, arrays[:n]),
                               jnp.asarray(arrays[n]), jx, **kw)
    got = getattr(tdit, name)(tp, tcfg, tt, *map(torch.from_numpy, arrays[:n]),
                              torch.from_numpy(arrays[n]), tx, **kw)
    return got.numpy(), np.asarray(want)


def test_bidirectional_against_jax(models):
    x, t = _inputs(3, 3, 500.0)
    got, want = _run(models, "dit_forward_bidirectional", x, t)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fpb", [1, 2])
def test_block_causal_against_jax(models, fpb):
    x, t = _inputs(4, 4, 500.0)
    got, want = _run(models, "dit_forward_block_causal", x, t, frames_per_block=fpb)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("context_noise", [0.0, 100.0])
def test_teacher_forcing_against_jax(models, context_noise):
    noisy, t = _inputs(5, 4, 700.0)
    clean, _ = _inputs(6, 4, 0.0)
    got, want = _run(models, "dit_forward_teacher_forcing", noisy, clean, t,
                     frames_per_block=2, context_noise=context_noise)
    np.testing.assert_allclose(got, want, **TOL)


def test_block_causal_refuses_a_partial_block(models):
    _, (tcfg, tp, tx, tt) = models
    x = torch.zeros(1, 3, 8, 8, 16)
    with pytest.raises(ValueError, match="whole number"):
        tdit.dit_forward_block_causal(tp, tcfg, tt, x, torch.zeros(1, 3), tx, 2)


# -- the properties of tests/test_semi_ar_loop.py, on the port ---------------

def test_bidirectional_forward(models):
    """Changing the last frame changes the first frame's output."""
    _, (tcfg, tp, tx, tt) = models
    x, t = map(torch.from_numpy, _inputs(3, 3, 500.0))
    flow = tdit.dit_forward_bidirectional(tp, tcfg, tt, x, t, tx)
    x2 = x.clone()
    x2[:, 2] *= -1.0
    flow2 = tdit.dit_forward_bidirectional(tp, tcfg, tt, x2, t, tx)
    assert flow.shape == x.shape
    assert (flow[:, 0] - flow2[:, 0]).abs().max() > 1e-6


def test_block_causal_full_sequence(models):
    """Later blocks do not affect earlier blocks' outputs, and do change
    their own."""
    _, (tcfg, tp, tx, tt) = models
    x, t = map(torch.from_numpy, _inputs(3, 4, 500.0))
    flow = tdit.dit_forward_block_causal(tp, tcfg, tt, x, t, tx, frames_per_block=2)
    x2 = x.clone()
    x2[:, 2:] *= -1.0
    flow2 = tdit.dit_forward_block_causal(tp, tcfg, tt, x2, t, tx, frames_per_block=2)
    assert torch.equal(flow[:, :2], flow2[:, :2])
    assert (flow[:, 2:] - flow2[:, 2:]).abs().max() > 0


def test_teacher_forcing_uses_clean_context(models):
    """Block 1 depends on block 0's clean context; block 0 does not depend
    on the clean tensor."""
    _, (tcfg, tp, tx, tt) = models
    noisy, t = map(torch.from_numpy, _inputs(4, 4, 700.0))
    clean = torch.from_numpy(_inputs(5, 4, 0.0)[0])
    a = tdit.dit_forward_teacher_forcing(tp, tcfg, tt, noisy, clean, t, tx,
                                         frames_per_block=2)
    clean2 = clean.clone()
    clean2[:, :2] *= -1.0
    b = tdit.dit_forward_teacher_forcing(tp, tcfg, tt, noisy, clean2, t, tx,
                                         frames_per_block=2)
    assert (a[:, 2:] - b[:, 2:]).abs().max() > 1e-6
    assert torch.equal(a[:, :2], b[:, :2])
