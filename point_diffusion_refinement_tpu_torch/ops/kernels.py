"""Build, load, launch and count the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, into
``<repo>/build/kernels/`` (listed in ``.gitignore``) under a name keyed by a
hash of the sources and flags, so a clean checkout builds them and a changed
source rebuilds.  A source may hold several kernels (``fps.cu`` has the
idx-only and the coordinates entry, ``attention_pool.cu`` the three sweeps of
the fused attention pool and its query-row pass); each kernel has its own launch count.
The libraries are bound with ``ctypes``: every pointer and the stream are
``c_void_p``, the stream is PyTorch's current one, and each C entry returns
``cudaGetLastError()``, which the launch checks.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into FMAs: the JAX
reference computes squared distances with separately rounded multiplies and
adds, and one contracted FMA can flip a radius boundary or an FPS argmax.

Routing: an op takes its plain PyTorch version for tensors on the CPU and
launches its kernel for tensors on the GPU.  ``plain_ops()`` is the one
explicit exception, a context that routes every op to its plain version on
any device so that a reference can be computed on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# kernel name -> (source, C entry, argtypes); the last argument is the stream
KERNELS = {
    "fps": ("fps.cu", "pdr_fps_coords", [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P]),
    "fps_idx": ("fps.cu", "pdr_fps_idx", [_P, _I, _I, _I, _P, _P, _I, _I, _P]),
    "ball_query": (
        "ball_query.cu", "pdr_ball_query", [_P, _P, _I, _I, _I, _I, _F, _P, _P, _P],
    ),
    "knn": ("knn.cu", "pdr_knn", [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "ball_group": (
        "ball_group.cu", "pdr_ball_group",
        [_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P],
    ),
    "ball_query_group": (
        "ball_query_group.cu", "pdr_ball_query_group",
        [_P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P],
    ),
    "group_scatter_add": (
        "group_scatter.cu", "pdr_group_scatter_add",
        [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    ),
    # the same sum in a fixed order (the default of every caller), of one
    # table or of two gathered with the same idx
    "group_scatter_ordered": (
        "group_scatter_ordered.cu", "pdr_group_scatter_ordered",
        [_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
    # the three sweeps of the fused attention pool (the first two finish
    # their GroupNorm vectors in their last cluster) and the pass that
    # writes the normalised query rows between the first two
    "attention_stats": (
        "attention_pool.cu", "pdr_attention_stats", [_P] * 21 + [_I] * 9 + [_P],
    ),
    "attention_qn": ("attention_pool.cu", "pdr_attention_qn", [_P] * 5 + [_I] * 3 + [_P]),
    "attention_hstats": (
        "attention_pool.cu", "pdr_attention_hstats", [_P] * 15 + [_I] * 7 + [_P],
    ),
    "attention_out": (
        "attention_pool.cu", "pdr_attention_out", [_P] * 21 + [_I] * 9 + [_P],
    ),
    "knn_group": (
        "knn_group.cu", "pdr_knn_group", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    ),
}

# host-side questions to a source's library (no launch, no stream, not counted)
QUERIES = {
    # the row blocks a sweep of the fused attention pool takes at given
    # sizes, and the row tiles a cluster of sweeps 1 and 2 holds (their
    # rows of partial sums are the one over the other)
    "attention_row_blocks": ("attention_pool.cu", "pdr_attention_row_blocks", [_I] * 9),
    "attention_cluster_size": ("attention_pool.cu", "pdr_attention_cluster_size", [_I] * 9),
    # the dynamic shared memory a launch of the fused ball group takes
    "ball_group_smem": ("ball_group.cu", "pdr_ball_group_smem", [_I] * 4),
    # the 4-byte workspace words of a launch of the ordered scatter-add
    "group_scatter_ordered_workspace": (
        "group_scatter_ordered.cu", "pdr_group_scatter_ordered_workspace", [_I] * 5,
    ),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}  # by source
_PLAIN_DEPTH = 0


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@contextlib.contextmanager
def plain_ops():
    """Route every op to its plain PyTorch version, on any device, for the
    duration of the context (a reference run on the card; never a
    fallback).  TF32 is off for matmuls and convolutions inside it, so the
    reference's float32 products run in full float32."""
    global _PLAIN_DEPTH
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _PLAIN_DEPTH += 1
    try:
        yield
    finally:
        _PLAIN_DEPTH -= 1
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def use_plain(t: torch.Tensor) -> bool:
    """True when an op on ``t`` takes its plain version: ``t`` lies on the
    CPU, or a ``plain_ops()`` context is active.  A CUDA tensor otherwise
    launches the kernel; any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}; use 'cuda' or 'cpu'")
    return _PLAIN_DEPTH > 0


def as_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous float32 tensor on its own device (a copy only
    where needed: positions are often a strided slice of a wider cloud)."""
    return t.to(torch.float32).contiguous()


def check(t: torch.Tensor, what: str, dtype: torch.dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose shape
    matches ``shape`` (None entries match anything)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(source: str) -> Path:
    """The library of ``source``, named by a hash of the source, every header
    of ``csrc/`` (any of them may be included) and the flags."""
    h = hashlib.sha256()
    for part in (CSRC / source, *sorted(CSRC.glob("*.cuh"))):
        h.update(part.name.encode())
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the sources of the named kernels (all by default) that are
    not built yet, one ``nvcc`` per source, all started together.  Returns
    the seconds each source's build took, keyed by its stem (0.0 for a
    library already on disk); raises with nvcc's output when a build
    fails."""
    sources = sorted({KERNELS[name][0] for name in (KERNELS if names is None else names)})
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    took = {}
    for source in sources:
        stem = Path(source).stem
        out = _library_path(source)
        if out.exists():
            took[stem] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / source)]
        procs[stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out, time.perf_counter())
    errors = []
    for stem, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {stem} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def _entry(name: str):
    """Kernel or query ``name``'s C entry, building and loading its source's
    library at first use."""
    source, symbol, _ = KERNELS[name] if name in KERNELS else QUERIES[name]
    lib = _LIBS.get(source)
    if lib is None:
        path = _library_path(source)
        if not path.exists():
            build([next(n for n, v in KERNELS.items() if v[0] == source)])
        lib = ctypes.CDLL(str(path))
        for src, sym, argtypes in (*KERNELS.values(), *QUERIES.values()):
            if src == source:
                entry = getattr(lib, sym)
                entry.argtypes = argtypes
                entry.restype = ctypes.c_int
        _LIBS[source] = lib
    return getattr(lib, symbol)


def query(name: str, *args) -> int:
    """Call the host-side C entry ``name`` of QUERIES (on a GPU machine)."""
    return int(_entry(name)(*args))


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry with ``args`` on the current stream,
    raise on a CUDA error, and count the launch."""
    entry = _entry(name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = entry(*args, stream)
    if rc != 0:
        raise RuntimeError(f"kernel {name}: CUDA error {rc} at launch")
    LAUNCHES[name] += 1
