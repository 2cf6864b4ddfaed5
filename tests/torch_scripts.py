"""Helpers of the port's tests that run the repo's scripts/*.py: load a
script by path, and a ``pl.pallas_call`` that runs in interpret mode and
records each call's inputs and output inside jit."""

import importlib.util
import itertools
import pathlib
import sys

import jax
import numpy as np
from jax.experimental import pallas as pl

REPO = pathlib.Path(__file__).resolve().parent.parent


def load_script(name):
    """scripts/<name>.py as a module, registered in ``sys.modules`` before
    it runs (the dataclasses of some scripts look their module up)."""
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def recording_pallas_call(captured: dict):
    """``pl.pallas_call`` in interpret mode whose calls record their inputs
    and output (as numpy arrays) through ``jax.debug.callback``: the call
    traced n-th sets ``captured[n]`` when it runs, so calls that run in
    other threads keep the order they were traced in."""
    real = pl.pallas_call
    traced = itertools.count()

    def pallas_call(*args, **kwargs):
        fn = real(*args, interpret=True, **kwargs)

        def call(*inputs):
            out = fn(*inputs)
            n = next(traced)

            def record(*vals):
                captured[n] = [np.asarray(v) for v in vals]
            jax.debug.callback(record, *inputs, out)
            return out
        return call
    return pallas_call


def in_trace_order(captured: dict) -> list:
    """The recorded calls as a list, in the order they were traced."""
    return [captured[n] for n in sorted(captured)]
