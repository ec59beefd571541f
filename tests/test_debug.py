"""Debug utilities: checkify wrapper."""

import jax.numpy as jnp
import numpy as np
import pytest

from radx_tpu.utils.debug import checked


def test_checked_raises_on_nan():
    def f(x):
        return jnp.log(x)  # log(-1) -> nan

    with pytest.raises(Exception):
        checked(f)(jnp.asarray([-1.0], jnp.float32))
    # and passes on clean input
    out = checked(f)(jnp.asarray([1.0], jnp.float32))
    assert np.allclose(np.asarray(out), 0.0)
