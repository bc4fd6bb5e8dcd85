"""Build and load the hand-written CUDA kernels and the host C libraries.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain `extern "C"` interface, loaded with ctypes; each `csrc/<name>.c` of
HOST_SOURCES (code for the host's CPU, no CUDA) compiles the same way with
the host's C compiler (`cc`, else `gcc`, from PATH), on the CPU too: the
JPEG decoder of `data/decode.py` and the GPT dataset's index helpers of
`data/helpers.py`. Libraries land in
`megatron_clip_tpu_torch/_build/` under a name that carries a hash of the
sources and flags, so a library is rebuilt only when a source changes. Nothing
is compiled at import: the first call that needs a library builds it, and
`build()` builds several at once, one compiler process per source. A build
writes a file of its own process and thread and renames it into place, so
processes that build the same library at once (test workers, decode
workers) each load a whole one.

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
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")
SOURCES = ("fused_mha", "layernorm", "flash_attention", "fused_ce")
# host C sources; the flags change no integer result
HOST_SOURCES = ("jpeg_decode", "dataset_helpers")
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c11")

_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
_lock = threading.Lock()
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


def _cc() -> str:
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found is not None:
            return found
    raise RuntimeError("no C compiler (cc or gcc) on PATH: the host "
                       "libraries (csrc/*.c) cannot be built")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.c" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str, defines: Tuple[str, ...]) -> Tuple[str, ...]:
    base = HOST_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    return base + tuple(f"-D{d}" for d in defines)


def _target(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(name, defines)).encode())
    h.update(_source(name).read_bytes())
    if name not in HOST_SOURCES:
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
    pairs for variants) that is not built yet, all compiler processes at
    once. Returns the seconds each build took (0 if it was already built),
    by `label`; raises with the compiler's output if one fails."""
    pending = {}
    took = {}
    for spec in names:
        name, defines = _spec(spec)
        out = _target(name, defines)
        if out.is_file():
            took[label(spec)] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        own = f".{os.getpid()}-{threading.get_ident()}"
        tmp = out.with_suffix(own + ".tmp")
        log = out.with_suffix(own + ".log")
        compiler = _cc() if name in HOST_SOURCES else _nvcc()
        cmd = [compiler, *_flags(name, defines), "-o", str(tmp),
               str(_source(name))]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        pending[label(spec)] = (proc, log, tmp, out, time.perf_counter())
    failed = []
    while pending:  # each build's own seconds, whatever order they end in
        for name in [n for n, job in pending.items()
                     if job[0].poll() is not None]:
            proc, log, tmp, out, t0 = pending.pop(name)
            took[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(log, out.with_suffix(".log"))
                os.replace(tmp, out)  # atomic: a loader sees all or nothing
            else:
                failed.append(f"{name}: {Path(proc.args[0]).name} exit "
                              f"{proc.returncode}\n" + log.read_text())
                log.unlink()
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The compiler's output (for a CUDA source, ptxas's register and
    shared-memory report) of the last build of `name`, or '' if none is on
    disk."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: Optional[dict] = None) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu` (of the `variant` in force)
    or for the host source `csrc/<name>.c`, built on first use.
    `signatures` maps function name -> (argtypes, restype)."""
    key = (name, () if name in HOST_SOURCES else _defines)
    lib = _libs.get(key)
    if lib is None:
        with _lock:  # one build and one load per process
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
