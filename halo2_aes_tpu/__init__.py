"""halo2_aes_tpu: a JAX AES-in-ZK proving stack for the GPU.

A from-scratch JAX/XLA framework (with CUDA kernels through the XLA FFI) with the capabilities of the
`tkmct/halo2-aes` circuit library *plus* the halo2 (PSE v0.3.0) proving
backend it depends on: a plonkish constraint system with tagged-table
lookups, a KZG/SHPLONK prover over BN254, batched AES-128 witness
generation, and multi-device scaling via jax.sharding.
"""

__version__ = "0.1.0"

from halo2_aes_tpu.ops import field  # noqa: F401
