"""uspace_tpu_torch.ops: each kernel's plain twin held to the JAX kernel.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_quant.py does; the port's wrappers take their plain twins for
CPU tensors. Inputs come from numpy seeds. Tolerances: f32 1e-5 (the same
arithmetic, summed in another order), bf16 2e-2 (one bf16 rounding of an
O(1) value is 8e-3).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uspace_tpu.ops import attention as jattn
from uspace_tpu.ops import mlp as jmlp
from uspace_tpu_torch.ops import _build
from uspace_tpu_torch.ops import attention as tattn
from uspace_tpu_torch.ops import mlp as tmlp

B, L, C, H = 2, 17, 64, 4  # ragged L: the TPU kernels pad it to 32 and mask
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed=0):
    r = np.random.default_rng(seed)
    return dict(
        qkv=r.standard_normal((B, L, 3 * C)).astype(np.float32),
        x=r.standard_normal((B, L, C)).astype(np.float32),
        w=(r.standard_normal((C, 3 * C)) * 0.2).astype(np.float32),
        s=(1 + 0.1 * r.standard_normal(C)).astype(np.float32),
        b=(0.1 * r.standard_normal(C)).astype(np.float32),
    )


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(port, ref, tol):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_packed_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs()
    ref = jattn.fused_qkv_attention(jnp.asarray(a["qkv"], jd), H,
                                    interpret=True)
    out = tattn.fused_qkv_attention(torch.from_numpy(a["qkv"]).to(td), H)
    assert out.dtype == td and out.shape == (B, L, C)
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_qkvproj_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs(1)
    ref = jattn.fused_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["w"]), H, interpret=True)
    out = tattn.fused_qkvproj_attention(torch.from_numpy(a["x"]).to(td),
                                        torch.from_numpy(a["w"]), H)
    assert out.dtype == td
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_ln_qkvproj_twin_matches_jax(dt):
    jd, td, tol = DTYPES[dt]
    a = _inputs(2)
    ref = jattn.fused_ln_qkvproj_attention(
        jnp.asarray(a["x"], jd), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
        jnp.asarray(a["w"]), H, quant=False, interpret=True)
    out = tattn.fused_ln_qkvproj_attention(
        torch.from_numpy(a["x"]).to(td), torch.from_numpy(a["s"]),
        torch.from_numpy(a["b"]), torch.from_numpy(a["w"]), H)
    _close(out, ref, tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_xla_attention_and_col_mult_match_jax(dt):
    jd, td, tol = DTYPES[dt]
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((B, H, L, 16)).astype(np.float32)
               for _ in range(3))
    m = (1 + 0.5 * r.random((B, L))).astype(np.float32)
    ref, ref_p = jattn.multi_head_attention(
        *(jnp.asarray(a, jd) for a in (q, k, v)), col_mult=jnp.asarray(m),
        return_probs=True)
    out, p = tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)),
        col_mult=torch.from_numpy(m), return_probs=True)
    _close(out, ref, tol)
    _close(p, ref_p, 1e-5)
    ref = jattn.multi_head_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    out = tattn.multi_head_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), impl="xla")
    _close(out, ref, tol)


def test_gelu_matches_jax_polynomial():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    _close(tmlp.gelu_exact(torch.from_numpy(x)),
           jmlp._gelu_exact(jnp.asarray(x)), 1e-6)
    _close(tmlp.erf_poly(torch.from_numpy(x)),
           jmlp._erf_poly(jnp.asarray(x)), 1e-6)


def test_unported_paths_raise():
    a = _inputs()
    x, w = torch.from_numpy(a["x"]), torch.from_numpy(a["w"])
    with pytest.raises(NotImplementedError, match="int8"):
        tattn.fused_qkvproj_attention(x, w, H, quant=True)
    with pytest.raises(NotImplementedError, match="int8"):
        tattn.fused_ln_qkvproj_attention(x, x[0, 0], x[0, 0], w, H,
                                         quant=True)
    q = torch.zeros(1, H, 8, 16)
    with pytest.raises(NotImplementedError, match="kernels 7-8"):
        tattn.multi_head_attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        tattn.multi_head_attention(q, q, q, impl="nope")


def test_cpu_twin_does_not_count_launches():
    tattn.reset_launches()
    a = _inputs()
    tattn.fused_qkv_attention(torch.from_numpy(a["qkv"]), H)
    tattn.fused_qkvproj_attention(torch.from_numpy(a["x"]),
                                  torch.from_numpy(a["w"]), H)
    assert set(tattn.LAUNCHES.values()) == {0}


def test_kernel_input_checks():
    """What the CUDA wrappers refuse, checked before any launch."""
    ok = torch.zeros(2, 257, 1024, dtype=torch.bfloat16)
    tattn._check_x("x", ok, 16, 1)
    tattn._check_x("qkv", torch.zeros(2, 512, 3 * 1024,
                                      dtype=torch.bfloat16), 16, 3)
    bad = [
        (ok.float(), 16, "bfloat16"),
        (ok, 8, "head dim"),
        (torch.zeros(2, 513, 1024, dtype=torch.bfloat16), 16, "L <="),
        (ok.transpose(0, 1).contiguous().transpose(0, 1), 16, "contiguous"),
    ]
    for x, h, msg in bad:
        with pytest.raises(ValueError, match=msg):
            tattn._check_x("x", x, h, 1)
    with pytest.raises(ValueError, match="w_qkv"):
        tattn._weight_rows(torch.zeros(1024, 1024), ok)
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_qkv_attention(torch.zeros(1, 4, 3 * 64, device="meta"), 1)
    w = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tattn._check_no_grad(ok, w)
    with torch.no_grad():
        tattn._check_no_grad(ok, w)


def test_ctypes_signatures_match_c_source():
    """Each declared argtypes list has one entry per C parameter, pointers
    as c_void_p (a 32-bit default would cut a pointer)."""
    src = (_build.CSRC / "attention.cu").read_text()
    for fn, argtypes in _build.SIGNATURES["attention"].items():
        m = re.search(rf"int {fn}\(([^)]*)\)", src)
        assert m, fn
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), fn
        for p, t in zip(params, argtypes):
            want = {"int": _build._I, "float": _build._F}.get(
                p.split()[0], _build._P)
            assert t is want, (fn, p)
    a, b = _build.library_path("attention"), _build.library_path("attention")
    assert a == b and a.parent == _build.BUILD_DIR
