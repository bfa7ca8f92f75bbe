"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source,
all started together, and link into one shared library with a plain C
interface, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds, not minutes). The build runs at first use and is cached
under ``build/pnp_vcve_torch/<hash of sources and flags>/`` at the root of
the checkout; ``nvcc -Xptxas -v`` output (registers, shared memory, spills
per kernel) is kept beside the library in ``build.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["Library", "library", "nvcc_path", "CSRC", "BUILD_ROOT", "SMEM_REPORT",
           "PROBE_SMEM_REPORT"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "pnp_vcve_torch"
LIB_NAME = "libpnp_vcve_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argument types (all return a cudaError_t as int);
# the model kernels take the width c after the sizes
SIGNATURES = {
    "pnp_warp": [_I, _P, _P, _P] + [_I] * 4 + [_P],
    "pnp_input_conv": [_I] + [_P] * 10 + [_I] * 5 + [_P],
    # K2's mma.sync design at any width (chip_smoke.py's yardstick)
    "pnp_input_conv_mma_sync": [_I] + [_P] * 10 + [_I] * 5 + [_P],
    "pnp_drt_block": [_I] + [_P] * 10 + [_I] * 4 + [_P],
    "pnp_drt_block_select": [_I] + [_P] * 12 + [_I] * 4 + [_P],
    # K3 / K3s's mma.sync design at any width (chip_smoke.py's yardstick)
    "pnp_drt_block_mma_sync": [_I, _I] + [_P] * 12 + [_I] * 4 + [_P],
    "pnp_warp_block": [_I, _P, _P, _P] + [_I] * 4 + [_P],
    "pnp_head": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    # K4's mma.sync design at any width (chip_smoke.py's yardstick)
    "pnp_head_mma_sync": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    "pnp_conv3x3": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    # K5's mma.sync design at any widths, and its wgmma design with the
    # other staging of its input (chip_smoke.py's yardsticks)
    "pnp_conv3x3_mma_sync": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "pnp_conv3x3_wg_alt_staging": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    # the probe kernels (probes.py)
    "pnp_window_copy": [_P, _P] + [_I] * 9 + [_P],
    "pnp_mmsel": [_P] * 4 + [_I] * 6 + [_L, _L] + [_I] * 5 + [_P],
    "pnp_matmul": [_I] + [_P] * 4 + [_I] * 3 + [_P],
    # K8's mma.sync design for bf16 too (chip_smoke.py's yardstick)
    "pnp_matmul_mma_sync": [_I] + [_P] * 4 + [_I] * 3 + [_P],
    "pnp_absmax_quantize": [_P, _L, _P, _P, _P, _I, _I, _P],
    "pnp_absmax_blocks_per_sm": [],
    "pnp_absmax_smem": [],
    "pnp_matmul8_smem": [_I],
    "pnp_tapconv": [_I] + [_P] * 4 + [_I] * 8 + [_P],
    "pnp_gather2": [_P] * 8 + [_I] * 6 + [_P],
    "pnp_block_windows": [_P] * 4 + [_I] * 4 + [_P],
    "pnp_ring_copy": [_P, _P] + [_I] * 8 + [_P],
    "pnp_stream_copy": [_P, _P] + [_I] * 5 + [_P],
    "pnp_ring_copy_smem": [_I] * 3,
}
# pnp_<name>_smem(c) return a (one-launch) block's dynamic shared memory in
# bytes at width c, those that depend on the feature type pnp_<name>_smem(c,
# dtype) (chip_smoke.py checks launch.MAX_WIDTH and ONE_LAUNCH_WIDTH on
# them): name -> whether it takes the dtype code; pnp_<name>_smem() that of a probe
SMEM_REPORT = {"warp_block": False, "input_conv": True, "drt_block": True, "head": True,
               "conv3x3": True}
PROBE_SMEM_REPORT = ("mmsel", "matmul", "tapconv", "tapconv8")


@dataclass
class Library:
    """The loaded kernels: ``lib`` (ctypes handle), where it came from, the
    compiler's report and the build's wall time (0 when it was cached)."""

    lib: ctypes.CDLL
    path: Path
    log: str
    build_seconds: float

    def check(self, rc: int, name: str):
        """Raise if a launch returned a CUDA error."""
        if rc != 0:
            msg = self.lib.pnp_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def nvcc_path() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _key(cu, cuh) -> str:
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, "-shared")).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path, cu) -> tuple[str, float]:
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels build "
            "only where the CUDA toolkit is installed"
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{f.stem}.o" for f in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(f)] for f, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = []
        for c, proc in zip(cmds, procs):
            text = proc.communicate()[0]
            log.append(" ".join(c) + "\n" + text)
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if not failed:
            # link under a temporary name, then rename: concurrent builders
            # never load a half-written library
            so_tmp = Path(tmp) / LIB_NAME
            cmd = [nvcc, *ARCH, "-shared", "-o", str(so_tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.returncode)
            else:
                os.replace(so_tmp, out_dir / LIB_NAME)
    log = "".join(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    (out_dir / "build.log").write_text(log)
    return log, time.perf_counter() - t0


@functools.cache
def library() -> Library:
    """Build (at first use) and load the kernels' shared library."""
    cu, cuh = _sources()
    out_dir = BUILD_ROOT / _key(cu, cuh)
    so = out_dir / LIB_NAME
    if so.exists():
        log_file = out_dir / "build.log"
        log, seconds = (log_file.read_text() if log_file.exists() else ""), 0.0
    else:
        log, seconds = _build(out_dir, cu)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    smem_args = {**{n: [_I] * (1 + typed) for n, typed in SMEM_REPORT.items()},
                 **{n: [] for n in PROBE_SMEM_REPORT}}
    for name, argtypes in smem_args.items():
        fn = getattr(lib, f"pnp_{name}_smem")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pnp_error_string.argtypes = [ctypes.c_int]
    lib.pnp_error_string.restype = ctypes.c_char_p
    return Library(lib=lib, path=so, log=log, build_seconds=seconds)
