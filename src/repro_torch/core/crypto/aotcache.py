"""The on-disk kernel cache of the limb backend (port of
``repro.core.crypto.aotcache``).

The reference caches its JAX ladder's ``jax.export`` blobs and XLA's
compiled programs, per lane bucket, so that a fresh process skips a
multi-second compile. The port's ladder is no XLA program: it is the
CUDA library that ``repro_torch.kernels._build`` compiles with ``nvcc``
at first use into ``build/repro_torch_kernels/<source hash>/`` beside
the checkout (``librlc_ladder.so``, one library for every lane count).
That directory is the cache: a fresh process that finds the library
loads it with ``ctypes`` in milliseconds, one that does not builds every
kernel source (seconds). The source hash keys it, so an edited kernel
lands in a fresh directory and a stale library is never loaded.

The reference's ``REPRO_CRYPTO_KERNEL_CACHE`` has no counterpart:
``_build.py`` fixes the directory.

CLI::

    python -m repro_torch.core.crypto.aotcache --warm  --lanes 2,16
    python -m repro_torch.core.crypto.aotcache --smoke --lanes 2,16 --expect-hit

``--warm`` builds the library if it is missing and runs each lane count
once; ``--smoke`` does the same and exits 1 on any failure, or (with
``--expect-hit``) where the library had to be built. Both need the card.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Optional, Tuple

from repro_torch.kernels import _build

KERNEL = "rlc_ladder"       # its entry in ``_build.SIGNATURES``

_HITS = 0
_MISSES = 0
_SOURCE: Optional[str] = None   # how this process got the library


def cache_root() -> Path:
    return _build.BUILD_ROOT


def kernel_path() -> Path:
    """The ladder's library for the current sources."""
    return _build.build_dir() / f"lib{_build.SIGNATURES[KERNEL][0]}.so"


def has_cached_kernels() -> bool:
    """Is the ladder's library for these sources built? The
    auto-calibration probe keys off this: without it the ``torch``
    candidate would pay a cold ``nvcc`` build."""
    return kernel_path().exists()


def load_kernel() -> Tuple[Callable[..., int], str]:
    """The ladder's C entry point, loaded once a process (built first if
    its library is missing), and how: "cache" or "build"."""
    global _HITS, _MISSES, _SOURCE
    if _SOURCE is None:
        hit = has_cached_kernels()
        fn = _build.entry_point(KERNEL)
        _SOURCE = "cache" if hit else "build"
        if hit:
            _HITS += 1
        else:
            _MISSES += 1
        return fn, _SOURCE
    return _build.entry_point(KERNEL), _SOURCE


def stats() -> dict:
    return {"hits": _HITS, "misses": _MISSES, "root": str(cache_root()),
            "path": str(kernel_path()), "built": has_cached_kernels()}


def _main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.crypto.aotcache",
        description="Warm or smoke-test the limb backend's kernel cache.")
    ap.add_argument("--warm", action="store_true",
                    help="build the ladder's library if it is missing and "
                         "run each lane count once")
    ap.add_argument("--smoke", action="store_true",
                    help="assert the warm-start path works end to end")
    ap.add_argument("--lanes", default="16",
                    help="comma-separated pow2 lane counts (default: 16)")
    ap.add_argument("--expect-hit", action="store_true",
                    help="with --smoke: fail unless the library was "
                         "already built (a cache-restore check)")
    args = ap.parse_args(argv)
    if not (args.warm or args.smoke):
        print(json.dumps(stats(), indent=2))
        return 0

    from repro_torch.core.crypto.backends import limb
    lanes = [int(x) for x in args.lanes.split(",") if x]
    report = {"stats": stats(), "buckets": []}
    failures = []
    for lane_count in lanes:
        info = limb.warm_bucket(lane_count)
        report["buckets"].append(info)
        if args.smoke:
            if info.get("error"):
                failures.append(f"l{lane_count}: {info['error']}")
            elif args.expect_hit and info["source"] != "cache":
                failures.append(
                    f"l{lane_count}: expected a built library, got "
                    f"{info['source']} (a cold nvcc build)")
    report["stats"] = stats()
    report["ok"] = not failures
    report["failures"] = failures
    print(json.dumps(report, indent=2))
    return 1 if failures else 0


if __name__ == "__main__":  # pragma: no cover - CLI
    raise SystemExit(_main())
