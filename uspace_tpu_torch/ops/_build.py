"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root
(listed in ``.gitignore``) and loaded with ``ctypes``. The library's file
name carries a hash of its source, so an edited kernel is never served from
a stale build. A failed build or load raises; nothing falls back.

The launch plumbing that every kernel wrapper shares is here too: argument
checks, the CPU/CUDA choice, the current stream and the C return code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of every entry point, by source name
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "attention": {
        "uspace_ln_rows": (_P, _P, _P, _P, _I, _I, _F, _P),
        "uspace_ln_row_codes": (_P,) * 5 + (_I, _I, _F, _P),
        "uspace_qkv_gemm": (_P, _P, _P, _I, _I, _I, _P),
        "uspace_qkv_gemm_int8": (_P,) * 5 + (_I, _I, _I, _P),
        "uspace_packed_attention": (_P, _P) + (_I,) * 4 + (_F, _P),
        "uspace_qkvproj_attention": (_P,) * 4 + (_I,) * 4 + (_F, _P),
        "uspace_ln_qkvproj_attention": (_P,) * 7 + (_I,) * 4 + (_F, _F, _P),
        "uspace_ln_qkvproj_attention_int8": (_P,) * 9 + (_I,) * 4 + (_F, _F,
                                                                     _P),
        "uspace_qkv_delta": (_P,) * 7 + (_I,) * 5 + (_P,),
        "uspace_xm_delta": (_P,) * 8 + (_I,) * 3 + (_P,),
        "uspace_qkv_amax": (_P,) * 5 + (_I,) * 3 + (_P,),
        "uspace_qkv_code": (_P,) * 8 + (_I,) * 5 + (_P,),
        "uspace_base_attn": (_P,) * 9 + (_I,) * 5 + (_F, _P),
    },
    "attention_block": {
        "uspace_row_codes": (_P, _P, _P, _I, _I, _P),
        "uspace_proj_residual_int8": (_P,) * 7 + (_I,) * 3 + (_P,),
    },
    "delta_attention": {
        "uspace_ln_codes": (_P,) * 5 + (_I,) * 4 + (_F, _P),
        "uspace_ln_delta_codes": (_P,) * 6 + (_I, _I, _F, _P),
        "uspace_diff_codes": (_P,) * 4 + (_I, _I, _P),
    },
    "delta_mlp": {
        "uspace_base_mlp_grad": (_P,) * 15 + (_I,) * 4 + (_F, _P),
        "uspace_base_mlp_e": (_P,) * 15 + (_I,) * 4 + (_F, _P),
        "uspace_base_mlp_eg": (_P,) * 18 + (_I,) * 4 + (_F, _P),
        "uspace_base_mlp_codes": (_P,) * 5 + (_I, _I, _F, _P),
        "uspace_base_fc1_grad": (_P,) * 10 + (_I,) * 4 + (_P,),
        "uspace_base_fc1_eg": (_P,) * 10 + (_I,) * 4 + (_P,),
        "uspace_base_fc2": (_P,) * 10 + (_I,) * 4 + (_P,),
        "uspace_delta_fc1_exact": (_P,) * 8 + (_I,) * 4 + (_P,),
        "uspace_delta_fc1_lin": (_P,) * 8 + (_I,) * 4 + (_P,),
        "uspace_delta_fc1_g": (_P,) * 11 + (_I,) * 4 + (_P,),
        "uspace_delta_fc2": (_P,) * 7 + (_I,) * 4 + (_P,),
        "uspace_mlp_int8_fc1": (_P,) * 8 + (_I,) * 4 + (_P,),
        "uspace_mlp_int8_fc2": (_P,) * 9 + (_I,) * 4 + (_P,),
        "uspace_mlp_int8_codes": (_P,) * 5 + (_I, _I, _F, _P),
        "uspace_ln_mlp_int8": (_P,) * 16 + (_I,) * 4 + (_F, _P),
    },
    "attention_fwd": {
        "uspace_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    },
    "flash_attention": {
        "uspace_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    },
    "fused_attention_bwd": {
        "uspace_fused_attention_bwd": (_P,) * 8 + (_I,) * 4 + (_F, _P),
        "uspace_packed_attention_bwd": (_P,) * 4 + (_I,) * 4 + (_F, _P),
    },
    "mlp_int8": {
        "uspace_mlp_int8": (_P,) * 9 + (_I,) * 5 + (_P,),
    },
    "mlp_bf16": {
        "uspace_bf16_fc1": (_P,) * 4 + (_I,) * 3 + (_P,),
        "uspace_bf16_fc2": (_P,) * 5 + (_I,) * 3 + (_P,),
    },
    "mlp_w8": {
        "uspace_mlp_w8": (_P,) * 9 + (_I,) * 4 + (_P,),
        "uspace_ln_mlp_w8": (_P,) * 12 + (_I,) * 4 + (_F, _P),
        "uspace_w8_ln_rows": (_P, _P, _P, _P, _I, _I, _F, _P),
        "uspace_w8_fc1": (_P,) * 5 + (_I,) * 3 + (_P,),
        "uspace_w8_fc2": (_P,) * 6 + (_I,) * 3 + (_P,),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on a machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(process or None, tmp_path, final_path)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp, out) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile the named sources, one nvcc process each, all in parallel."""
    jobs = [(n, *_start_build(n)) for n in names]
    errors = []
    for job in jobs:
        try:
            _finish_build(*job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Refuse an argument a kernel cannot read as given."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def check_no_grad(*ts: torch.Tensor, what: str) -> None:
    """Kernels that define no backward (nor do the JAX package's): refuse
    rather than return an output that silently drops the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{what} is inference-only, as in the JAX package; call under "
            "torch.no_grad() or train the bf16 view with "
            "attn_impl='pallas_packed', 'auto' or 'xla'")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper runs its plain twin), False for a
    CUDA tensor (it launches its kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def cuda_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed: cudaError {rc}")
