"""Build and load the port's CUDA kernels.

The sources in `../csrc/*.cu` expose plain C entry points. At first use each
source is compiled by its own `nvcc` process (all started together) for
`sm_90a`, the objects are linked into one shared library under the repo's
`build/` directory, and the library is loaded with `ctypes`. ptxas's report
of each kernel's registers and spills is kept beside the library
(`resource_usage`). The library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt and never mixed with a stale build; a finished build is moved into
place atomically, so concurrent first uses in several processes are safe.

Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
PTXAS_FLAGS = ("-Xptxas", "-v")  # the report only: the code is the same without it

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double
_U = ctypes.c_ulonglong
# the attention entries' last arguments: rate, seed, head_total, head0, stream
_DROP = (_D, _U, _I, _I, _P)
# entry point -> argtypes; every entry returns a cudaError_t as int, but those
# in RESTYPES
SIGNATURES = {
    "dqvq_decode_attention_int8": (_P,) * 6 + (_I, _I, _I, _I, _I, _F, _I, _P),
    "dqvq_decode_attention_int8_device_index": (_P,) * 6 + (_I, _I, _I, _I, _P, _F, _I, _P),
    "dqvq_fused_attention_forward": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, *_DROP),
    "dqvq_fused_attention_backward": (_P,) * 10 + (_I, _I, _I, _I, _F, _I, _I, *_DROP),
    "dqvq_fused_attention_backward_wide_f32": (_P,) * 10 + (_I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_fused_attention_forward_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_fused_attention_forward_f32_tc": (_P,) * 5 + (_I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_fused_attention_forward_wide_f32": (_P,) * 5 + (_I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_fused_attention_backward_tc": (_P,) * 10 + (_I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_fused_attention_backward_f32_tc": (_P,) * 10 + (_I, _I, _I, _I, _F, _I, *_DROP),
    "dqvq_layernorm_forward": (_P, _P, _P, _P, _I, _I, _F, _I, _I, _P),
    "dqvq_layernorm_backward": (_P,) * 7 + (_I, _I, _I, _F, _I, _I, _P),
    "dqvq_layernorm_backward_occupancy": (_I, _I, _P, _P),
    "dqvq_fused_adamw": (_P,) * 5 + (_L,) + (_F,) * 9 + (_I, _P),
    "dqvq_fused_adamw_device_scalars": (_P,) * 5 + (_L, _P) + (_F,) * 6 + (_I, _P),
    "dqvq_vq_nearest": (_P,) * 7 + (_I, _I, _I, _P),
    "dqvq_vq_nearest_train": (_P,) * 9 + (_I, _I, _I, _P),
    "dqvq_vq_nearest_fma": (_P,) * 5 + (_I, _I, _I, _P),
    "dqvq_vq_nearest_tc_scores": (_P,) * 7 + (_I, _I, _I, _P),
    "dqvq_vq_workspace_bytes": (_I, _I, _I, _I),
    "dqvq_patch_entropy": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P),
    "dqvq_patch_entropy_block": (_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    "dqvq_strided_conv_down": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "dqvq_strided_conv_down_tc_pack": (_P, _P, _P, _I, _I, _P),
    "dqvq_strided_conv_down_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "dqvq_strided_conv_down_f32_pack": (_P, _P, _I, _I, _I, _P),
    "dqvq_strided_conv_down_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
}

# each attention entry beside its `_device_seed` twin, which reads the seed
# from a device int64 (the pointer in place of the by-value seed); both end
# with (head_total, head0, stream)
SIGNATURES.update({
    f"{name}_device_seed": args[:-4] + (_P,) + args[-3:] for name, args in list(SIGNATURES.items())
    if name.startswith("dqvq_fused_attention_")})

RESTYPES = {"dqvq_vq_workspace_bytes": _L}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    found = candidate if os.path.exists(candidate) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _fingerprint() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources (one nvcc per source, in parallel) and link them
    into one shared library; returns its path."""
    out = os.path.join(BUILD_DIR, f"libdqvq_kernels-{_fingerprint()}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", src, "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, logs = [], []
        for src, _, proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode:
                print(f"[nvcc {os.path.basename(src)}]\n{log}", flush=True)
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed for {', '.join(failed)}")
        tmp_so = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp_so,
                        *(o for _, o, _ in procs)], check=True)
        tmp_log = os.path.join(tmp, "ptxas.txt")
        with open(tmp_log, "w") as f:
            f.write("".join(logs))
        os.replace(tmp_log, out + ".ptxas.txt")
        os.replace(tmp_so, out)
    return out


def resource_usage() -> dict:
    """{kernel: {"registers", "spill_stores", "spill_loads"}} for every kernel
    of the built library, from ptxas's report (`-Xptxas -v`) kept beside it;
    names demangled where `c++filt` exists, cut before the argument list."""
    with open(build() + ".ptxas.txt") as f:
        report = f.read()
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name in usage:
            usage[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name in usage:
            usage[name]["registers"] = int(m.group(1))
    names = list(usage)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
        if len(out) == len(names):
            usage = {_short(d): usage[n] for n, d in zip(names, out)}
    return usage


def _short(demangled: str) -> str:
    name = demangled.replace("(anonymous namespace)::", "").replace("dqvq::", "")
    return name.split("(")[0].removeprefix("void ")


def lib():
    """The loaded kernel library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _lib = handle
        return _lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
