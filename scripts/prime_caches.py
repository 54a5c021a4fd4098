"""One-command cache priming for serving deployments.

Cold-start economics (BASELINE.md): the first-ever prove on a fresh host
is compile-bound (SRS generation + keygen + XLA and kernel compiles).  A serving deployment must pay that ONCE, explicitly, before
taking traffic — not implicitly inside whichever request arrives first.

This script warms every disk cache the prover uses, in order:
  1. ptau/kzg_bn254_{k}_*.npz          — SRS powers (backend/srs.py)
  2. ptau/msm_tables_{k}_*.npz         — per-window shifted MSM tables
  3. ptau/pk_*_s{k}_*.npz              — proving-key commitments+assembly
  4. ptau/xla_cache/ (or $JAX_COMPILATION_CACHE_DIR) — persistent XLA
     executable cache (utils/cache.py)

Usage:
    python scripts/prime_caches.py [k] [blocks] [sets] [--tagged] [...]

All flags are forwarded verbatim to prove_steady.py (unknown flags fail
there rather than being silently dropped).  Runs from the repo root
regardless of the caller's CWD so the ptau/ caches land where serving
reads them.  Defaults to the k=17 full-capacity single-set config
(96 blocks).  After one successful run, steady-state proves need no
compile and keygen loads from disk in seconds.

XLA cache keys are sensitive to the exact entry graphs: to warm the
cache for ``bench.py``'s own shape, run ``python bench.py`` once.

(The reference's analog is the `ptau/` SRS cache in src/main.rs:70-75,
which covers only the SRS — this also covers pk, MSM tables, and
compiled executables.)
"""

import os
import pathlib
import runpy
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

if __name__ == "__main__":
    os.chdir(REPO)  # anchor ptau/ caches to the repo root
    positional = [a for a in sys.argv[1:] if not a.startswith("--")]
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    k = positional[0] if len(positional) > 0 else "17"
    blocks = positional[1] if len(positional) > 1 else "96"
    sets = positional[2] if len(positional) > 2 else "1"
    sys.argv = ["prove_steady.py", k, blocks, sets] + flags
    runpy.run_path(str(REPO / "scripts" / "prove_steady.py"),
                   run_name="__main__")
