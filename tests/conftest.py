"""Test configuration: run everything on a virtual 8-device CPU mesh.

Correctness tests run on the CPU with
``xla_force_host_platform_device_count=8`` so multi-device sharding is
exercised without real cards (same semantics, per JAX's SPMD model).

``HALO2_TEST_ON_CARD=1`` leaves JAX on its default accelerator instead
(``chip_smoke.py`` sets it to run the ``gpu``-marked tests on the card).
"""

import os

ON_CARD = os.environ.get("HALO2_TEST_ON_CARD") == "1"

if not ON_CARD:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
# NOTE: the persistent compilation cache stays off on the CPU: jaxlib
# segfaults deserializing cached executables of the big MSM scan graphs
# (utils/cache.py).  In-process pjit caching still applies.
