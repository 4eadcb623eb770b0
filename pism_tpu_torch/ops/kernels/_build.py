"""Build and load the hand-written CUDA kernels.

Each source ``pism_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/<hash of source, headers and flags>/lib<name>.so`` at the
repository root (ignored by git), then loaded with ctypes. A library is
built once per source hash; :func:`build` compiles several sources at once,
one ``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or PATH)")
    return nvcc


def _lib_path(name: str) -> pathlib.Path:
    # the headers of csrc/ count in the key: a source may include them
    src = b"".join(p.read_bytes() for p in (CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build(*names: str) -> None:
    """Compile the named sources that are not built yet, in parallel."""
    jobs = []
    try:
        for name in names:
            lib_path = _lib_path(name)
            if lib_path.exists():
                continue
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            # build beside the target, then rename: concurrent builds never
            # load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
            os.close(fd)
            src = CSRC / f"{name}.cu"
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, tmp, lib_path, proc))
        failed = []
        for src, tmp, lib_path, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, lib_path)
            else:
                failed.append(f"nvcc failed on {src}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build(name)
    return ctypes.CDLL(str(_lib_path(name)))


@functools.lru_cache(maxsize=None)
def _cuda_calls():
    """torch's calls for the current device's index and a device's current
    stream as an int, the raw ones where torch has them (they make no
    device or Stream object)."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return (getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device),
            raw or (lambda i: torch.cuda.current_stream(i).cuda_stream))


def launch(fn, name: str, device, *args) -> None:
    """Call a C entry point with the current stream of ``device`` (a CUDA
    device or its index) as its last argument, read at each call so that
    graph capture sees its stream, with ``device`` made current only while
    it is not; raise if the entry point reports a CUDA error."""
    current, stream = _cuda_calls()
    index = device if isinstance(device, int) else device.index
    if index == current():
        err = fn(*args, stream(index))
    else:
        import torch

        with torch.cuda.device(index):
            err = fn(*args, stream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")


def check(name: str, *tensors, strided=()) -> None:
    """Raise unless the tensors (and those of ``strided``) share one dtype
    (float32 or float64) and one device (cpu or cuda), and the tensors are
    contiguous; a kernel reads those of ``strided`` through their
    strides."""
    import torch

    t0 = tensors[0]
    dtype, index, cpu = t0.dtype, t0.get_device(), t0.is_cpu
    # what every call passes, in a few attribute reads a tensor
    if (dtype is torch.float32 or dtype is torch.float64) \
            and (cpu or t0.is_cuda):
        for t in tensors:
            if (t.dtype is not dtype or t.get_device() != index
                    or t.is_cpu is not cpu or not t.is_contiguous()):
                break
        else:
            for t in strided:
                if (t.dtype is not dtype or t.get_device() != index
                        or t.is_cpu is not cpu):
                    break
            else:
                return
    if t0.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {t0.dtype}")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {t0.device}")
    for t in (*tensors, *strided):
        if t.device != t0.device:
            raise ValueError(f"{name} inputs lie on different devices")
        if t.dtype != t0.dtype:
            raise TypeError(f"{name} inputs have different dtypes")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")


_WORK = {}


def workspace(name: str, device, nkeys: int = 1, words: int = 0):
    """The int64 words of work of kernel ``name`` on ``device``, made once
    per device and layout; launches that share them run in order on one
    stream. With ``words`` 0, those that take the max of a grid of
    ``nkeys`` members (``csrc/grid_max.cuh``): a ticket, 0, and a key per
    member, the least int64, which every launch leaves as it found them.
    Else ``words`` zeros, the first ``nkeys`` of them tickets that every
    launch leaves at 0 and the rest its scratch (``csrc/member_dot.cu``)."""
    import torch

    key = (name, device, nkeys, words)
    w = _WORK.get(key)
    if w is None:
        w = _WORK[key] = (
            torch.zeros(words, dtype=torch.int64, device=device) if words
            else torch.tensor([0] + [-2 ** 63] * nkeys, dtype=torch.int64,
                              device=device))
    return w


def max_out(name: str, like, with_max: bool, members: int = 0):
    """(max_D, (work, max_D) pointers) for a launch of kernel ``name`` that
    takes the max of a grid into a new tensor of ``like``'s dtype and
    device, 0-dim, or one value per member for a launch of ``members`` > 0
    members; (None, (None, None)) for a launch without it."""
    import torch

    if not with_max:
        return None, (None, None)
    max_D = torch.empty((members,) if members else (), dtype=like.dtype,
                        device=like.device)
    return max_D, (workspace(name, like.device, max(members, 1)).data_ptr(),
                   max_D.data_ptr())
