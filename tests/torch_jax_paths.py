"""Which path the JAX package's cached rounds take in the port's parity tests.

The port runs K1 (its fused pair-GN kernel, or K1's plain version on CPU
tensors) whenever ``fused_kernel=True``, on every device: that is the twin
of JAX on its accelerator, and the production configs depend on it. The JAX
package takes its fused Pallas kernel only on a TPU or with
``O3S_FUSED_INTERPRET=1`` (``open3d_slam_private_tpu/models/icp.py:1039-1048``,
read when a step is traced); off a TPU without it, it takes the moment path,
another algorithm. So every parity test against a ``fused_kernel=True``
config turns the flag on, here; ``tests/test_torch_path_choice.py`` pins
both behaviours. A test module takes the fixture by importing it::

    from tests.torch_jax_paths import jax_fused_path  # noqa: F401

and a script calls :func:`use_jax_fused_path` before it imports JAX. JAX's
jitted steps are cached per static config and per process, so a test that
needs one path must trace a config no test of the other path traces.
"""

import os

import pytest

FLAG = "O3S_FUSED_INTERPRET"


@pytest.fixture(autouse=True)
def jax_fused_path(monkeypatch):
    """JAX's cached rounds on the fused pair-GN kernel, in interpret mode."""
    monkeypatch.setenv(FLAG, "1")


def use_jax_fused_path() -> None:
    """The fixture's setting for a script (kept if the caller set it)."""
    os.environ.setdefault(FLAG, "1")
