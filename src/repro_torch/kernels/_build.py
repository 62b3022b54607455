"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``. The build happens at first use, from the sources in this
checkout only, into ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout; ``<hash>`` covers every source and the compiler flags, so
an edited kernel is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry name -> (source, C entry point, argtypes); pointers and the stream
# are c_void_p so ctypes never cuts them to 32 bits
SIGNATURES = {
    "cosine_partials": ("cosine_partials", "repro_cosine_partials",
                        [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _L, _L,
                         _P]),
    "weighted_agg": ("weighted_agg", "repro_weighted_agg",
                     [_P, _I, _P, _P, _I, _L, _I, _P]),
    "wkv6": ("wkv6", "repro_wkv6",
             [_P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _P, *[_I] * 10,
              _P]),
    "wkv6_backward": ("wkv6", "repro_wkv6_backward",
                      [_P, _P, _P, _P, _L, _L, _L, _P, _P, _P, _L, _L, _L,
                       *[_P] * 8, *[_I] * 7, _P]),
    "flash_attention": ("flash_attention", "repro_flash_attention",
                        [_P, _P, _P, _P, _P, *[_L] * 9, *[_I] * 9, _P]),
    "flash_attention_backward": (
        "flash_attention", "repro_flash_attention_backward",
        [*[_P] * 10, *[_L] * 12, *[_I] * 9, _P]),
    "rlc_ladder": ("rlc_ladder", "repro_rlc_ladder",
                   [_P, _P, _P, _I, _I, _P, _P, _P, _P]),
}
SOURCES = tuple(dict.fromkeys(src for src, _, _ in SIGNATURES.values()))

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FNS: Dict[str, Callable[..., int]] = {}


def source_hash() -> str:
    """sha256 over every kernel source and the flags, first 16 hex."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels cannot be built")
    return nvcc


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build_all() -> Dict[str, float]:
    """Compile every source that has no library yet, one ``nvcc`` each,
    all started together. Returns {name: seconds} of the builds run; the
    compiler's register/spill report lands in ``<name>.log`` beside each
    library. Every ``nvcc`` started is waited for, or killed on error."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: a concurrent build of the
    # same hash never sees a half-written library
    tmp = {name: out_dir / f".lib{name}.{os.getpid()}.so" for name in SOURCES}
    logs, procs, seconds = {}, {}, {}
    t0 = time.perf_counter()
    try:
        for name in SOURCES:
            if (out_dir / f"lib{name}.so").exists():
                continue
            logs[name] = open(out_dir / f"{name}.log", "w")
            procs[name] = subprocess.Popen(nvcc_command(name, tmp[name]),
                                           stdout=logs[name],
                                           stderr=subprocess.STDOUT)
        for name, proc in procs.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            if rc != 0:
                logs[name].flush()
                raise RuntimeError(
                    f"nvcc failed on {name}.cu (exit {rc}):\n"
                    f"{(out_dir / f'{name}.log').read_text()}")
            os.replace(tmp[name], out_dir / f"lib{name}.so")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
    return seconds


def build_log(name: str) -> str:
    return (build_dir() / f"{name}.log").read_text()


def entry_point(name: str) -> Callable[..., int]:
    """The C entry point ``name`` (a key of :data:`SIGNATURES`) of its
    source's library, with its argtypes set, built first if needed. It
    returns the launch's CUDA error code."""
    fn = _FNS.get(name)
    if fn is None:
        source, symbol, argtypes = SIGNATURES[name]
        path = build_dir() / f"lib{source}.so"
        if not path.exists():
            build_all()
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn
