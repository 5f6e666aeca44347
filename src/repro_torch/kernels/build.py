"""Build and load the port's CUDA kernels (nvcc by hand, bound by ctypes).

At first use :func:`load` compiles each source of :data:`SOURCES`
(``csrc/iaat_gemm.cu``, ``csrc/grouped_gemm.cu``, both on the shared
``csrc/tile.cuh``) once per real letter (S, D, H), each source of
:data:`SOURCES_CX` (``csrc/cx_gemm.cu``, the complex Karatsuba kernel)
once per complex letter (C, Z), each object holding the template
instances the install-time table (``core.kernelgen``) lists for that
letter, and each source of :data:`SOURCES_ONCE`
(``csrc/flash_attention.cu``, its f32 and bf16 instances in one object)
once; all nine ``nvcc`` jobs start together.  The objects are linked
into one shared library with a plain C interface.  The library lands
in ``build/repro_torch/<key>/`` at the root of the checkout, where ``key``
hashes the sources, the generated instance lists and the flags, so an
edit to any of them rebuilds and nothing stale is ever loaded.  Without
``nvcc`` it raises: a CUDA run never goes on without its kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

from repro_torch.core import kernelgen

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LETTER_CODE = {letter: i for i, letter in enumerate(kernelgen.TABLE_LETTERS)}
#: kernel sources, each built once per real letter (S, D, H); the C
#: entries they export are ``<stem>_<letter>``
SOURCES = ("iaat_gemm", "grouped_gemm")
#: kernel sources built once per complex letter (C, Z); there is no
#: complex grouped kernel, as in the reference
SOURCES_CX = ("cx_gemm",)
#: kernel sources built once, their instances independent of the table
SOURCES_ONCE = ("flash_attention",)

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built from source at first use on the card")
    return path


def _tables() -> Dict[str, str]:
    """Generated instance list per letter: one IAAT_INSTANCE line each."""
    out: Dict[str, str] = {}
    for letter in kernelgen.TABLE_LETTERS:
        lines = [f"IAAT_INSTANCE({bm}, {bn}, {bk})"
                 for (lt, bm, bn, bk) in kernelgen.instances() if lt == letter]
        out[letter] = "\n".join(lines) + "\n"
    return out


def build_key() -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for letter, text in sorted(_tables().items()):
        h.update(letter.encode())
        h.update(text.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the library if its key is not built yet; return its path.
    The ptxas report (registers, spills per instance) is kept beside it
    in ``ptxas.log``."""
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / "libiaat_gemm.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    for letter, text in _tables().items():
        (work / f"iaat_table_{letter}.inc").write_text(text)
    jobs = [(src, f"{src}_{letter}.o",
             [f"-DIAAT_LETTER={_LETTER_CODE[letter]}"])
            for srcs, letters in ((SOURCES, kernelgen.KERNEL_LETTERS),
                                  (SOURCES_CX, kernelgen.COMPLEX_LETTERS))
            for src in srcs for letter in letters]
    jobs += [(src, f"{src}.o", []) for src in SOURCES_ONCE]
    procs, objs = [], []
    for src, name, defs in jobs:
        obj = str(work / name)
        cmd = [nvcc, *NVCC_FLAGS, *defs, f"-I{work}", "-c",
               str(CSRC / f"{src}.cu"), "-o", obj]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    log = []
    failed = None
    for cmd, p in procs:
        text, _ = p.communicate()
        log.append(text)
        if p.returncode and failed is None:
            failed = (cmd, text)
    (work / "ptxas.log").write_text("".join(log))
    if failed is not None:
        raise RuntimeError(f"nvcc failed: {' '.join(failed[0])}\n{failed[1]}")
    res = subprocess.run([nvcc, "-shared", *objs, "-o",
                          str(work / lib.name)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    try:
        os.replace(work, out_dir)
    except OSError:
        # another process finished the same key first; keep its build
        shutil.rmtree(work, ignore_errors=True)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, ll, i, d = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
            ctypes.c_double
        argtypes = {
            "iaat_gemm": [i, i, i, p, ll, ll, p, ll, ll, p, ll, ll, p, ll, ll,
                          i, i, i, d, d, p],
            "batched_gemm": [i, i, i, p, ll, ll, ll, p, ll, ll, ll, p, ll, ll,
                             ll, i, i, i, i, p],
            "ragged_gemm": [i, i, i, p, ll, ll, p, ll, ll, ll, p, i, i, p, ll,
                            ll, i, i, p],
        }
        for stem, types in argtypes.items():
            for letter in kernelgen.KERNEL_LETTERS:
                fn = getattr(lib, f"{stem}_{letter}")
                fn.argtypes = types
                fn.restype = i
        for letter in kernelgen.COMPLEX_LETTERS:
            fn = getattr(lib, f"cx_gemm_{letter}")
            fn.argtypes = [i, i, i, p, ll, ll, p, ll, ll, p, ll, ll, p, ll,
                           ll, i, i, i, d, d, d, d, p]
            fn.restype = i
        s = ctypes.POINTER(ll)      # four strides
        lib.flash_attention.argtypes = [i, i, p, s, p, s, p, s, p, s, i, i,
                                        i, i, i, i, i, i, ctypes.c_float, p]
        lib.flash_attention.restype = i
        lib.iaat_error_string.argtypes = [i]
        lib.iaat_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
