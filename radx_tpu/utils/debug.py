"""Debug / sanitizer utilities — SURVEY §5's race-detection analogue.

The reference's only correctness tooling is commented-out Vulkan validation
layers (sort.hpp:121-133) and manual RenderDoc captures.  Here:

  * `checked` — wrap a jittable function with jax.experimental.checkify to
    surface NaN / OOB-index / div-by-zero errors from inside jit.
"""

from __future__ import annotations


def checked(fn):
    """Wrap fn so float/index errors inside jit raise on the host."""
    import jax
    from jax.experimental import checkify

    errors = checkify.user_checks | checkify.nan_checks | checkify.index_checks

    cfn = checkify.checkify(fn, errors=errors)

    def wrapper(*args, **kwargs):
        err, out = jax.jit(cfn)(*args, **kwargs)
        err.throw()
        return out

    return wrapper
