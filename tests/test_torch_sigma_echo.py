"""Port's sigma-frame echo against the JAX reference (CPU), on the parity
cases of test_torch_sigma_evolve.py (same drives, uniforms and
tolerances)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtc_tpu.core.sigma_evolve import sigma_echo_batch as j_echo
from dtc_tpu_torch.core.sigma_evolve import sigma_echo_batch
from test_torch_sigma_evolve import CASES, ECHO_TS, reference_case, tolerance

torch.set_num_threads(2)


@pytest.mark.parametrize("pol,L,p,state,dtype", CASES)
def test_sigma_echo_matches_reference(pol, L, p, state, dtype):
    jax_args, (h, ph, ang, (_uf, ue)), kw = reference_case(pol, L, p, state,
                                                           dtype)
    ref = np.asarray(j_echo(*jax_args, jnp.asarray(ECHO_TS), **kw))
    got = sigma_echo_batch(h, ph, ang, torch.tensor(ECHO_TS), ue,
                           **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=tolerance(dtype), rtol=0)
    if p > 0.5:
        assert got.min() < 0  # sampled events flipped trajectories
