"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain `extern "C"` interface, loaded with ctypes. Libraries land in
`megatron_clip_tpu_torch/_build/` under a name that carries a hash of the
sources and flags, so a library is rebuilt only when a source changes. Nothing
is compiled at import: the first call that needs a kernel builds it, and
`build()` builds several at once, one nvcc process per source.

A variant is a source built with preprocessor defines (the checks build
kernels made wrong on purpose, `csrc/philox.cuh`'s MCT_DROPOUT_FAULT);
inside `with variant(...)` every `load` returns the libraries of that
variant.
"""
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")
SOURCES = ("fused_mha", "layernorm", "flash_attention", "fused_ce")

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# the defines `load` builds with (see `variant`)
_defines: Tuple[str, ...] = ()
Spec = Union[str, Tuple[str, Tuple[str, ...]]]


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    tag = "".join("-" + d.replace("=", "") for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def _spec(spec: Spec) -> Tuple[str, Tuple[str, ...]]:
    return (spec, ()) if isinstance(spec, str) else (spec[0],
                                                     tuple(spec[1]))


def label(spec: Spec) -> str:
    """A spec's name, with its defines: `name` or `name[DEF=1]`."""
    name, defines = _spec(spec)
    return name + (f"[{','.join(defines)}]" if defines else "")


def build(names: Iterable[Spec] = SOURCES) -> Dict[str, float]:
    """Compile every library in `names` (source names, or (name, defines)
    pairs for variants) that is not built yet, all nvcc processes at once.
    Returns the seconds each build took (0 if it was already built), by
    `label`; raises with nvcc's output if one fails."""
    pending = {}
    took = {}
    for spec in names:
        name, defines = _spec(spec)
        out = _target(name, defines)
        if out.is_file():
            took[label(spec)] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        pending[label(spec)] = (subprocess.Popen(cmd, stdout=log,
                                                 stderr=subprocess.STDOUT),
                                log, tmp, out, time.perf_counter())
    failed = []
    while pending:  # each build's own seconds, whatever order they end in
        for name in [n for n, job in pending.items()
                     if job[0].poll() is not None]:
            proc, log, tmp, out, t0 = pending.pop(name)
            took[name] = time.perf_counter() - t0
            log.close()
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: a loader sees all or nothing
            else:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                              + out.with_suffix(".log").read_text())
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the last
    build of `name`, or '' if none is on disk."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (of the `variant` in force),
    built on first use. `signatures` maps function name -> (argtypes,
    restype)."""
    key = (name, _defines)
    lib = _libs.get(key)
    if lib is None:
        build([key])
        lib = ctypes.CDLL(str(_target(*key)))
        _libs[key] = lib
    # each caller's signatures, also on a library another caller loaded
    for fn, (argtypes, restype) in (signatures or {}).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


@contextlib.contextmanager
def variant(*defines: str):
    """Inside the block `load` returns the libraries built with `defines`
    (e.g. "MCT_DROPOUT_FAULT=1"); a check's way to run a kernel made wrong
    on purpose through the same wrappers."""
    global _defines
    old, _defines = _defines, tuple(defines)
    try:
        yield
    finally:
        _defines = old
