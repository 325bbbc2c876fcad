"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``)."""
import contextlib

import jax
import jax.experimental
import pytest


@contextlib.contextmanager
def x64_shim_applied():
    """The reference's packed sort calls ``jax.experimental.enable_x64``,
    which JAX 0.9 removed; stand in ``jax.enable_x64(True)`` where it is
    missing, and nothing where it exists."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            @contextlib.contextmanager
            def enable_x64():
                with jax.enable_x64(True):
                    yield

            mp.setattr(jax.experimental, "enable_x64", enable_x64, raising=False)
        yield


@pytest.fixture
def x64_shim():
    with x64_shim_applied():
        yield
