"""Numeric-safety debug modes.

Port of lane_tracker_tpu/utils/debug.py.  What is worth guarding in the
functional tracker is numeric health (NaN/Inf escaping the guarded
degenerate-fit paths) and accidental nondeterminism.  JAX's
``debug_nans`` / ``debug_infs`` find the first primitive whose output is
not finite by re-running op by op; here ``debug_mode`` checks every
operator's output as it runs, through a ``TorchDispatchMode``, and
``assert_states_equal`` compares two tracker states field by field.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Factories whose output is uninitialised memory: whatever bits they hold
# are not a result, so they are not checked.
_UNINITIALISED = frozenset(
    ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"))


class _NonFiniteCheck(TorchDispatchMode):
    """Raise FloatingPointError, naming the operator, at the first
    operator whose floating output holds a NaN or an Inf."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALISED:
            return out
        for x in tree_leaves(out):
            if (isinstance(x, torch.Tensor)
                    and (x.is_floating_point() or x.is_complex())
                    and not bool(torch.isfinite(x).all())):
                raise FloatingPointError(
                    f"{func} produced NaN or Inf in its "
                    f"{tuple(x.shape)} {x.dtype} output")
        return out


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Scope in which any NaN/Inf produced by a PyTorch operator (the
    tracker step's among them) raises immediately with the offending
    operator, instead of silently flowing into detection flags.  Each
    checked operator reads its output's finiteness on the host, so the
    scope is slow.  On exit, even by an exception, the previous state is
    restored."""
    if not nan_checks:
        yield
        return
    with _NonFiniteCheck():
        yield


def assert_states_equal(a, b, atol=0.0):
    """Determinism check: two tracker states (``TrackerState``, tensors
    on any device) must be identical, or within ``atol``.

    Useful for verifying that replaying a stream (or resuming from a
    snapshot) reproduces the exact same trajectory.
    """
    for name, la, lb in zip(a._fields, a, b):
        la, lb = (np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in (la, lb))
        if atol == 0.0:
            if not np.array_equal(la, lb):
                raise AssertionError(f"state field {name} differs")
        else:
            np.testing.assert_allclose(la, lb, atol=atol, err_msg=name)
