import numpy as np


def f32(v) -> float:
    """A Python float holding exactly the float32 rounding of ``v``.

    Scalar operands of float32 tensor arithmetic are passed this way so
    each equals the reference's ``jnp.float32`` constant whatever precision
    the backend converts scalars in."""
    return float(np.float32(v))
