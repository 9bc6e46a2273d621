"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into ``build/kernels/lib<name>-<hash>.so`` under the repo
root (listed in ``.gitignore``), loaded with ``ctypes``.  The hash covers
every file in ``csrc/`` and the flags, so an edited source rebuilds and a
fresh checkout builds at first use.  Every library links libcuda (the
driver library, for ``cuTensorMapEncodeTiled``: the wgmma routes' TMA
maps), found through the toolkit's link stubs; nothing links cuBLAS.
Nothing here runs at import time: this module is imported on machines
with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-lcuda",)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (pathlib.Path(home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and pathlib.Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build only on a machine with the "
                       "CUDA toolkit")


def _stub_dirs(nvcc: str):
    """The toolkit's directories of link stubs (``libcuda.so`` for
    linking; the driver's own library is loaded at run time)."""
    home = pathlib.Path(nvcc).resolve().parents[1]
    return [d for d in (home / "lib64" / "stubs",
                        home / "targets" / "x86_64-linux" / "lib" / "stubs")
            if d.is_dir()]


def target(name: str) -> pathlib.Path:
    """Path of the shared library for ``csrc/<name>.cu`` at the current
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns {name: compiler log} for the
    ones compiled now ("" for a library already built); raises with the
    log if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs = {}, {}
    for name in names:
        out = target(name)
        if out.exists():
            logs[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        stubs = [f"-L{d}" for d in _stub_dirs(nvcc)]
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
               *stubs, *LINK_FLAGS]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built on first use."""
    build([name])
    return ctypes.CDLL(str(target(name)))
