"""ODE solvers for flow-matching sampling and inversion.

Counterpart of ``uspace_tpu/core/solvers.py``:

- fixed-step euler / midpoint / rk4 over a precomputed f32 time grid,
  forward or reverse in time, optionally stacking per-step auxiliary
  outputs (the activation taps of u-space reads). PyTorch runs eagerly, so
  the JAX ``lax.scan`` is a Python loop;
- adaptive embedded Runge-Kutta (dopri5, bosh3, adaptive_heun) with the I
  or PI step controller, driven from the host as torchdiffeq drives it and
  as the JAX package's ``odeint_adaptive_host(program="stages")`` does;
- the reference's ``solver_kwargs`` dispatch, including the fixed/adaptive
  split ("fixadp") that editing uses;
- the base-anchored stage-delta field (``stage_delta=(vf_base,
  vf_delta)``, ``core/delta_field.py``): stage 2 of each adaptive step
  runs the base, which returns the step's cache, and stages 3..s run the
  delta on it, as the JAX host loop does.

Velocity-field signature: ``vf(t, x) -> dx/dt`` with ``t`` a 0-d f32 CPU
tensor, or ``vf(t, x) -> (dx/dt, aux)`` with ``has_aux=True`` (fixed-step
only).

A fixed step follows the JAX sampler's arithmetic: the Python scalar step
size takes the dtype of the field's output (JAX weak typing), and XLA
evaluates the update at the state's precision. So a bf16 field advances an
f32 state by ``f32(bf16(dt)) * f32(v)``.

An adaptive step follows the JAX adaptive loops' arithmetic instead: the
signed step ``hs`` and the stage times are strong f32 scalars, each stage
combination ``sum_j a_ij k_j`` is taken in f32 and rounded back to the
field's dtype before ``x + hs * comb`` (in f32), and the error estimate is
``hs * bf16(sum_j b_err_j k_j)`` for a bf16 field. Stage combinations, the
error ratio and the initial-step probes are eager tensor operations on the
state's device; the one synchronisation per step attempt is the
``float(ratio)`` the controller needs, and the controller arithmetic is
Python floats, as in the JAX host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

FIXED_METHODS = ("euler", "midpoint", "rk4")
CONTROLLERS = ("i", "pi")

_RTOL = 1e-5  # the reference's defaults (torchdiffeq rtol = atol = 1e-5)
_ATOL = 1e-5

_BARE_FIELD = (
    "solver_kwargs field='stage_delta_int8' needs its (vf_base, vf_delta) "
    "pair as solver_kwargs['stage_delta']: the sampling layer "
    "(cli/sample_lfm) builds it from the model with "
    "core/delta_field.make_delta_field")


def _weak(c: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing applies it to ``like``."""
    return float(torch.tensor(c, dtype=like.dtype))


def _axpy(x: torch.Tensor, a: float, k: torch.Tensor) -> torch.Tensor:
    """x + a * k at x's precision, with ``a`` rounded to k's dtype."""
    return x + _weak(a, k) * k.to(x.dtype)


def _stack(auxs: List[Any]) -> Any:
    """Stack per-step aux outputs along a new leading axis (tensors, and
    dicts/tuples/lists of them; None stays None)."""
    first = auxs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(auxs)
    if isinstance(first, dict):
        return {k: _stack([a[k] for a in auxs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(z)) for z in zip(*auxs))
    raise TypeError(f"cannot stack aux of type {type(first).__name__}")


def odeint_fixed(
    vf: Callable,
    x0: torch.Tensor,
    t0: float,
    t1: float,
    num_steps: int,
    method: str = "euler",
    has_aux: bool = False,
):
    """Integrate ``dx/dt = vf(t, x)`` from t0 to t1 in ``num_steps`` equal
    steps (t1 < t0 integrates backwards: exact inversion).

    Returns ``x(t1)``; with ``has_aux=True``, ``(x(t1), stacked_aux)``
    where aux comes from the first field evaluation of each step.
    """
    if method not in FIXED_METHODS:
        raise NotImplementedError(f"fixed-step method {method!r}")
    vf_aux = vf if has_aux else (lambda t, x: (vf(t, x), None))
    dt = (t1 - t0) / num_steps
    # the grid is computed, never accumulated: t_i = t0 + dt * i in f32
    ts = t0 + dt * torch.arange(num_steps, dtype=torch.float32)
    half = dt / 2
    x = x0
    auxs = []
    for t in ts:
        k1, aux = vf_aux(t, x)
        if method == "euler":
            dx = k1
        elif method == "midpoint":
            dx, _ = vf_aux(t + half, _axpy(x, half, k1))
        else:  # classic rk4
            k2, _ = vf_aux(t + half, _axpy(x, half, k1))
            k3, _ = vf_aux(t + half, _axpy(x, half, k2))
            k4, _ = vf_aux(t + dt, _axpy(x, dt, k3))
            dx = (k1.to(x.dtype) + 2 * k2.to(x.dtype) + 2 * k3.to(x.dtype)
                  + k4.to(x.dtype)) / 6.0
        x = x + _weak(dt, k1) * dx.to(x.dtype)
        auxs.append(aux)
    if has_aux:
        return x, _stack(auxs)
    return x


# ---------------------------------------------------------------------------
# Adaptive embedded Runge-Kutta methods
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Tableau:
    """Explicit embedded RK tableau (c, a, b_high, b_err)."""

    order: int  # order used for step-size control exponent
    c: tuple
    a: tuple  # lower-triangular rows, row i has i entries
    b: tuple  # high-order weights
    b_err: tuple  # b_high - b_low, for the error estimate
    fsal: bool  # first-same-as-last


# Dormand-Prince 5(4), the torchdiffeq "dopri5" default
_DOPRI5 = _Tableau(
    order=5,
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    a=(
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(
        35 / 384 - 1951 / 21600,
        0.0,
        500 / 1113 - 22642 / 50085,
        125 / 192 - 451 / 720,
        -2187 / 6784 - -12231 / 42400,
        11 / 84 - 649 / 6300,
        -1.0 / 60.0,
    ),
    fsal=True,
)

# Bogacki-Shampine 3(2), torchdiffeq "bosh3"
_BOSH3 = _Tableau(
    order=3,
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    a=((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    fsal=True,
)

# Heun-Euler 2(1), torchdiffeq "adaptive_heun"
_HEUN = _Tableau(
    order=2,
    c=(0.0, 1.0),
    a=((), (1.0,)),
    b=(1 / 2, 1 / 2),
    b_err=(1 / 2 - 1.0, 1 / 2),
    fsal=False,
)

_TABLEAUS = {"dopri5": _DOPRI5, "bosh3": _BOSH3, "adaptive_heun": _HEUN}
ADAPTIVE_METHODS = tuple(_TABLEAUS)


def _f32(v: float) -> float:
    """``v`` rounded to f32 (the JAX loops' strong f32 scalars)."""
    return float(np.float32(v))


def _t(v: float) -> torch.Tensor:
    """A 0-d f32 CPU tensor: the time argument of a field."""
    return torch.tensor(v, dtype=torch.float32)


def _rms_norm(a: torch.Tensor) -> torch.Tensor:
    """sqrt(mean(a^2)) in f32, the mean a sum divided by the count once."""
    sq = a.float().square().sum()
    return torch.sqrt(sq / torch.full((), a.numel(), dtype=sq.dtype,
                                      device=sq.device))


def _error_ratio(err: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                 rtol: float, atol: float) -> torch.Tensor:
    """RMS of ``err / (atol + rtol * max(|x0|, |x1|))`` in f32."""
    tol = atol + rtol * torch.maximum(x0.float().abs(), x1.float().abs())
    return _rms_norm(err.float() / tol)


def _combine(w, ks: List[torch.Tensor]) -> torch.Tensor:
    """``sum_j w[j] * ks[j]`` in f32 (w as f32), rounded to the stages'
    dtype, as the JAX loops' stage contraction; terms of weight 0 are
    skipped (they add an exact zero)."""
    terms = [_f32(wj) * kj.float() for wj, kj in zip(w, ks) if wj != 0.0]
    return sum(terms[1:], terms[0]).to(ks[0].dtype)


def _initial_step(vf: Callable, t0: float, x0: torch.Tensor,
                  f0: torch.Tensor, direction: float, order: int,
                  rtol: float, atol: float) -> float:
    """The Hairer/Wanner initial step (torchdiffeq ``_select_initial_step``)
    term by term as the JAX ``init_h0`` / ``probe_x`` / ``init_h1``: f32
    device scalars, one field evaluation at the probe, one host read."""
    sc = atol + rtol * x0.float().abs()
    d0 = _rms_norm(x0.float() / sc)
    d1 = _rms_norm(f0.float() / sc)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6), 0.01 * d0 / d1)
    # x0 + (direction * h0) * f0, at the probe time f32(t0) + f32(dir) * h0
    x1 = x0 + (direction * h0) * f0.to(x0.dtype)
    t1 = (torch.full((), _f32(t0), dtype=torch.float32, device=h0.device)
          + direction * h0)
    f1 = vf(_t(float(t1)), x1)
    # f1 - f0 in the field's dtype, then scaled in f32
    d2 = _rms_norm((f1 - f0).float() / sc) / h0
    dm = torch.maximum(d1, d2)
    h1 = torch.where(dm <= 1e-15,
                     torch.clamp(h0 * 1e-3, min=1e-6),
                     torch.pow(torch.full_like(dm, 0.01) / dm, 1.0 / order))
    return float(torch.minimum(100.0 * h0, h1))


def odeint_adaptive(
    vf: Callable,
    x0: torch.Tensor,
    t0: float,
    t1: float,
    method: str = "dopri5",
    rtol: float = _RTOL,
    atol: float = _ATOL,
    max_steps: int = 4096,
    safety: float = 0.9,
    ifactor: float = 10.0,
    dfactor: float = 0.2,
    controller: str = "i",
    pcoeff: float = 0.4,
    icoeff: float = 0.7,
    return_stats: bool = False,
    stage_delta: Optional[tuple] = None,
):
    """Adaptive embedded-RK integration of ``dx/dt = vf(t, x)`` from t0 to
    t1 (t1 < t0 integrates backwards), driven from the host: one field
    evaluation per stage, eager stage combinations on the state's device,
    and one ``float(ratio)`` per step attempt for the controller.

    ``controller="i"`` is torchdiffeq's integral rule: accept when the
    scaled RMS error ratio is <= 1; next step ``h * clip(safety *
    ratio^(-1/order), dfactor, ifactor)``. ``controller="pi"`` is the
    Hairer/Soderlind rule ``h *= safety * ratio^(-icoeff/order) *
    ratio_prev^(pcoeff/order)``, ``ratio_prev`` from the last accepted
    step; the acceptance test is the same.

    ``return_stats=True`` also returns ``{"steps", "accepted", "nfe",
    "t"}``: step attempts, accepted steps, field evaluations (``2 +
    per_step * steps``, the 2 spent by the initial-step heuristic
    included) and the time reached. The loop stops at ``max_steps``
    attempts whether or not it reached t1; ``t`` shows which.

    ``stage_delta=(vf_base, vf_delta)``: ``vf_base(t, x) -> (f, cache)``,
    ``vf_delta(t, x, cache) -> f``; ``vf`` is ignored. Stage 2 of each step
    runs the base and stages 3..s the delta on its cache (the JAX host
    loop's dispatch, ``uspace_tpu/core/solvers.py:700-711``); the first
    evaluation, the initial-step probe and a non-FSAL last stage take the
    base's f. NFE counts every evaluation alike (dopri5: 1 base and 5
    deltas a step).
    """
    if method not in _TABLEAUS:
        raise NotImplementedError(f"adaptive method {method!r}")
    if controller not in CONTROLLERS:
        raise ValueError(f"unknown step controller {controller!r}")
    tab = _TABLEAUS[method]
    n_stage = len(tab.c)
    direction = 1.0 if t1 >= t0 else -1.0
    if stage_delta is not None:
        vf_base, vf_delta = stage_delta
        vf = lambda t, x: vf_base(t, x)[0]  # noqa: E731

    f = vf(_t(_f32(t0)), x0)
    h = _initial_step(vf, t0, x0, f, direction, tab.order, rtol, atol)
    t, x = float(t0), x0
    r_prev = 1.0
    n = n_acc = 0
    while n < max_steps and direction * (t1 - t) > 1e-8:
        h_step = min(h, abs(t1 - t))
        hs = _f32(h_step * direction)
        ks = [f]
        cache = None
        for i in range(1, n_stage):
            # x + hs * comb in x's (f32) precision, hs a strong f32
            xi = x + hs * _combine(tab.a[i], ks).to(x.dtype)
            ti = _t(_f32(t + tab.c[i] * h_step * direction))
            if stage_delta is None:
                ks.append(vf(ti, xi))
            elif i == 1:  # a fresh base evaluation anchors the step's cache
                k, cache = vf_base(ti, xi)
                ks.append(k)
            else:
                ks.append(vf_delta(ti, xi, cache))
        cache = None  # freed before the next step's base builds its own
        x_new = x + hs * _combine(tab.b, ks).to(x.dtype)
        err = hs * _combine(tab.b_err, ks).float()
        ratio = max(float(_error_ratio(err, x, x_new, rtol, atol)), 1e-10)
        f_last = (ks[-1] if tab.fsal
                  else vf(_t(_f32(t + h_step * direction)), x_new))
        accept = ratio <= 1.0
        if controller == "pi":
            factor = safety * ratio ** (-icoeff / tab.order) \
                * r_prev ** (pcoeff / tab.order)
        else:
            factor = safety * ratio ** (-1.0 / tab.order)
        h = h_step * min(max(factor, dfactor), ifactor)
        n += 1
        if accept:
            t += h_step * direction
            x, f = x_new, f_last
            r_prev = ratio
            n_acc += 1
    if return_stats:
        per_step = n_stage - 1 if tab.fsal else n_stage
        return x, {"steps": n, "accepted": n_acc,
                   "nfe": 2 + per_step * n, "t": t}
    return x


# the JAX package has a device loop and a host loop; the port has the host
# loop only, under both names
odeint_adaptive_host = odeint_adaptive


# ---------------------------------------------------------------------------
# Reference-compatible dispatch (solver_kwargs surface)
# ---------------------------------------------------------------------------


def num_fixed_steps(t0: float, t1: float, step_size: float) -> int:
    """Static step count for a fixed-step solve (torchdiffeq step grid)."""
    return max(1, int(round(abs(t1 - t0) / step_size)))


def odeint(
    vf: Callable,
    x0: torch.Tensor,
    t0: float,
    t1: float,
    solver_kwargs: Optional[dict] = None,
    t_mid: Optional[float] = None,
    has_aux: bool = False,
    stats: Optional[Dict[str, Any]] = None,
):
    """Dispatch on the reference's ``solver_kwargs`` dict:

    - ``{"solver": "fixed", "solver_fix": m, "solver_fix_step": s}``;
    - ``{"solver": "adaptive", "solver_adaptive": m}`` (the default:
      dopri5);
    - ``{"solver": "fixadp", ...}``: fixed-step on [t0, t_mid], adaptive on
      [t_mid, t1] (the reference's split at the edit time).

    Keys read by the adaptive solves: ``rtol`` / ``atol`` (1e-5),
    ``controller`` ("i") and ``safety`` (0.9, torchdiffeq's), as in the JAX
    package, ``max_steps`` (4096) and ``stage_delta`` (the pair of
    :func:`odeint_adaptive`; ``vf`` may then be None for "adaptive"). The
    config knob ``field="stage_delta_int8"`` names that pair but cannot
    carry it: the sampling layer builds it, and a bare ``field`` is refused
    here. A ``dict`` passed as ``stats`` receives the adaptive solve's
    statistics (see :func:`odeint_adaptive`).
    """
    sk = dict(solver_kwargs or {"solver": "adaptive",
                                "solver_adaptive": "dopri5"})
    kind = sk.get("solver", "adaptive")
    if kind == "fixed":
        n = num_fixed_steps(t0, t1, sk.get("solver_fix_step", 0.01))
        return odeint_fixed(vf, x0, t0, t1, n,
                            method=sk.get("solver_fix", "euler"),
                            has_aux=has_aux)
    if kind not in ("adaptive", "fixadp"):
        raise ValueError(f"unknown solver {kind!r}")
    if has_aux:
        raise ValueError("activation capture requires a fixed-step solver")
    stage_delta = sk.get("stage_delta")
    field = sk.get("field")
    if field not in (None, "", "stage_delta_int8"):
        raise NotImplementedError(f"solver_kwargs field={field!r}")
    if field and stage_delta is None:
        raise ValueError(_BARE_FIELD)
    kw = dict(method=sk.get("solver_adaptive", "dopri5"),
              rtol=sk.get("rtol", _RTOL), atol=sk.get("atol", _ATOL),
              controller=sk.get("controller", "i"),
              safety=sk.get("safety", 0.9),
              max_steps=sk.get("max_steps", 4096), return_stats=True,
              stage_delta=stage_delta)
    if kind == "fixadp":
        if t_mid is None:
            raise ValueError("fixadp requires t_mid (the reference uses "
                             "t_edit)")
        n = num_fixed_steps(t0, t_mid, sk.get("solver_fix_step", 0.01))
        x0 = odeint_fixed(vf, x0, t0, t_mid, n,
                          method=sk.get("solver_fix", "euler"))
        t0 = t_mid
    x, st = odeint_adaptive(vf, x0, t0, t1, **kw)
    if stats is not None:
        stats.update(st)
    return x
