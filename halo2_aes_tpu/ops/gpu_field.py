"""BN254 field and G1 kernels in CUDA, called through the XLA FFI.

On the GPU every field add, subtract, negate and Montgomery multiply of
``ops/field.py`` and every point add and doubling of ``ops/curve.py``
is one call of a kernel in ``gpu_field.cu`` (one thread per element,
the whole operation in registers).  XLA then compiles small graphs of
gathers, sorts and these calls instead of thousands of limb ops, and
the source is built once per process with ``nvcc``, not once per call
site.  Elsewhere the XLA limb code runs.

The same source builds with the host C++ compiler into CPU handlers,
which the tests use to check the kernels' arithmetic and this module's
wrappers on a machine without a GPU.

The library is cached under the temp directory by a hash of the source,
the generated constants and the compiler command.  On the GPU a failed
build raises; it never falls back to the XLA path quietly.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from halo2_aes_tpu.ops import field as F

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gpu_field.cu")
_FIELD_IDS = {F.FR: 0, F.FQ: 1}
_TARGETS = {"field_binary": "H2aFieldBinary", "field_neg": "H2aFieldNeg",
            "g1_add": "H2aG1Add", "g1_double": "H2aG1Double"}
_OPS = {"mul": 0, "add": 1, "sub": 2}


def use_kernels(spec: F.FieldSpec | None = None,
                platform: str | None = None) -> bool:
    """The kernels serve BN254 Fr and Fq on the GPU backend."""
    platform = platform or jax.default_backend()
    return platform == "gpu" and (spec is None or spec in _FIELD_IDS)


def _params_header() -> str:
    """C initializers of ``Field`` for Fr and Fq, from python bigints."""
    def init(spec):
        p = spec.modulus
        words = ", ".join(f"0x{(p >> (32 * i)) & 0xFFFFFFFF:08x}u"
                          for i in range(8))
        n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        return f"{{{{{words}}}, 0x{n0:08x}u}}"

    return (f"#define H2A_FR {init(F.FR)}\n"
            f"#define H2A_FQ {init(F.FQ)}\n")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("gpu_field: nvcc not found (needs the CUDA toolkit)")


def _compile_cmd(platform: str, out: str, inc: str) -> list[str]:
    common = ["-O3", "-std=c++17", "-shared", "-I", inc, "-I",
              jax.ffi.include_dir(), "-o", out, _SRC]
    if platform == "cpu":
        return ["g++", "-x", "c++", "-fPIC", *common]
    major, minor = jax.devices()[0].compute_capability.split(".")
    return [_nvcc(), f"-arch=sm_{major}{minor}", "-Xcompiler", "-fPIC",
            *common]


@functools.lru_cache(maxsize=None)
def _build(platform: str) -> str:
    """Compile the library for ``platform`` ("gpu" or "cpu"); cached."""
    with open(_SRC, "rb") as f:
        src = f.read()
    header = _params_header()
    probe = _compile_cmd(platform, "OUT", "INC")
    tag = hashlib.blake2b(src + header.encode() + " ".join(probe).encode(),
                          digest_size=12).hexdigest()
    root = os.path.join(tempfile.gettempdir(), f"h2a_gpu_field_{tag}")
    so = os.path.join(root, f"h2a_{platform}.so")
    if not os.path.exists(so):
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "h2a_field_params.h"), "w") as f:
            f.write(header)
        tmp = f"{so}.build{os.getpid()}"
        res = subprocess.run(_compile_cmd(platform, tmp, root),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"gpu_field: building the {platform} library "
                               f"failed:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _register(platform: str) -> str:
    """Build and register the targets for ``platform``; returns the name
    prefix of its targets."""
    import ctypes

    lib = ctypes.cdll.LoadLibrary(_build(platform))
    prefix = f"h2a_{platform}_"
    xla_platform = "CUDA" if platform == "gpu" else "cpu"
    for name, sym in _TARGETS.items():
        jax.ffi.register_ffi_target(prefix + name,
                                    jax.ffi.pycapsule(getattr(lib, sym)),
                                    platform=xla_platform)
    return prefix


def _call(target: str, n_out: int, arrays, platform: str | None, **attrs):
    """Broadcast ``arrays`` to one (..., LIMBS) shape and run ``target``
    over the flattened rows; returns ``n_out`` arrays of that shape."""
    shape = jnp.broadcast_shapes(*(a.shape for a in arrays))
    if len(shape) == 0 or shape[-1] != F.LIMBS:
        raise ValueError(f"limb axis must be {F.LIMBS}, got shape {shape}")
    arrays = [jnp.broadcast_to(jnp.asarray(a, jnp.uint32), shape)
              for a in arrays]
    if int(np.prod(shape)) == 0:
        return [jnp.zeros(shape, jnp.uint32) for _ in range(n_out)]
    prefix = _register(platform or jax.default_backend())
    out = jax.ffi.ffi_call(
        prefix + target,
        [jax.ShapeDtypeStruct(shape, jnp.uint32)] * n_out,
        vmap_method="broadcast_all")(*arrays, **attrs)
    return list(out)


def _binary(op: str, spec, a, b, platform=None):
    return _call("field_binary", 1, (a, b), platform,
                 field=np.int32(_FIELD_IDS[spec]), op=np.int32(_OPS[op]))[0]


def mont_mul(spec: F.FieldSpec, a, b, platform: str | None = None):
    return _binary("mul", spec, a, b, platform)


def add(spec: F.FieldSpec, a, b, platform: str | None = None):
    return _binary("add", spec, a, b, platform)


def sub(spec: F.FieldSpec, a, b, platform: str | None = None):
    return _binary("sub", spec, a, b, platform)


def neg(spec: F.FieldSpec, a, platform: str | None = None):
    return _call("field_neg", 1, (a,), platform,
                 field=np.int32(_FIELD_IDS[spec]))[0]


def g1_add(p, q, platform: str | None = None):
    """RCB complete addition of projective Fq points (X, Y, Z)."""
    return tuple(_call("g1_add", 3, (*p, *q), platform))


def g1_double(p, platform: str | None = None):
    """RCB complete doubling of projective Fq points (X, Y, Z)."""
    return tuple(_call("g1_double", 3, tuple(p), platform))
