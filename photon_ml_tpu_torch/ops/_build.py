"""Build and load the port's CUDA kernels.

Each source under photon_ml_tpu_torch/csrc/ is compiled by `nvcc` into a
shared library with a plain C interface and loaded with ctypes; a variant
(`VARIANTS`) is one more library from a source with flags of its own, so
its instantiations compile beside the source's in a second nvcc.  The build
runs at first use, into build/photon_ml_tpu_torch/ at the root of the
checkout, and again whenever the source or the flags change (the library's
file name carries their hash).  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

from photon_ml_tpu_torch.telemetry.timings import clock

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "photon_ml_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> its C entry points' ctypes signatures (restype, argtypes)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "fused_value_and_gradient": {
        "pmt_fused_value_and_gradient":
            (_I, [_I, _I] + [_P] * 10 + [_LL] + [_I] * 6 + [_P]),
        "pmt_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_value_and_gradient_lanes": {
        "pmt_fused_value_and_gradient_lanes":
            (_I, [_I, _I] + [_P] * 11 + [_LL] + [_I] * 7 + [_P]),
        "pmt_lanes_error_string": (ctypes.c_char_p, [_I]),
    },
    "ell_sparse": {
        "pmt_ell_margin_loss": (_I, [_I, _I] + [_P] * 10 + [_LL] + [_I] * 7 + [_P]),
        "pmt_csc_column_sum": (_I, [_I, _I] + [_P] * 10 + [_LL, _I, _I, _I, _P]),
        "pmt_ell_error_string": (ctypes.c_char_p, [_I]),
    },
}


# library -> (its source, extra nvcc flags): the lanes kernel's bf16 X
# instantiations, compiled apart from its float32 ones, so the two halves
# build side by side
VARIANTS = {"fused_value_and_gradient_lanes_bf16":
            ("fused_value_and_gradient_lanes", ("-DLANES_XBYTES=2",))}
LIBRARIES = tuple(SIGNATURES) + tuple(VARIANTS)


def _source(name: str) -> Tuple[str, Tuple[str, ...]]:
    return VARIANTS.get(name, (name, ()))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    source, extra = _source(name)
    src = (CSRC / f"{source}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + extra).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


#: every nvcc build and library load of this process, in order:
#: (library, nvcc ran, seconds).  cli.train's `compile_s`/`compile_count`
#: read it; each entry is also reported to the telemetry compile watch
LOADS: List[Tuple[str, bool, float]] = []


def _report(library: str, nvcc: bool, seconds: float) -> None:
    from photon_ml_tpu_torch.telemetry import core
    LOADS.append((library, nvcc, seconds))
    core.note_kernel_library(library, nvcc, seconds)


def build_all(names=LIBRARIES) -> Dict[str, float]:
    """Compile every stale library, one nvcc per source, all started
    together.  Returns {name: seconds} for the sources it compiled; the
    compiler's register/shared-memory report lands beside each library as
    `<lib>.log`.  Each compile is reported as a build (`LOADS`)."""
    seconds = _build_stale(names)
    for name, s in seconds.items():
        _report(name, True, s)
    return seconds


def _build_stale(names) -> Dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        source, extra = _source(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                      tmp, out, log, clock())
    seconds = {}
    failed = []
    for name, (proc, tmp, out, log, t0) in jobs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = clock() - t0
        if rc != 0:
            failed.append(f"{name} (see {out.with_suffix('.log')})")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library for kernel `name`, with argtypes/restype set.
    The load (with its build, if nvcc ran for it) is reported once
    (`LOADS`)."""
    t0 = clock()
    built = _build_stale((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[_source(name)[0]].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _report(name, name in built, clock() - t0)
    return lib
