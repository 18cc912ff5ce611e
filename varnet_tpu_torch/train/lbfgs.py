"""L-BFGS with a zoom line search: what ``optax.lbfgs()`` computes (optax 0.2.6,
``alias.py::lbfgs``, ``transform.py::scale_by_lbfgs``,
``linesearch.py::zoom_linesearch``), for ``VarNet.refine_lbfgs``.

The parameters are one flat vector (``models/mlp.py::ravel_params``).  One
iteration of :func:`lbfgs_iteration`:

1. the memory takes (w - w_prev, g - g_prev) and its weight 1 / (dg . dw) (0
   where that product is 0) in the slot of the previous iteration;
2. the two-loop recursion multiplies g by the inverse-Hessian estimate, from
   gamma I with gamma = (dg . dw) / |dg|^2 (``scale_init_precond``), at the first
   iteration min(1, 1 / |g|); the direction is d = -P g;
3. the zoom line search (Nocedal & Wright, algorithms 3.5 / 3.6, with Hager &
   Zhang's approximate decrease test) picks eta from eta = 1 (optax's
   ``initial_guess_strategy='one'``), at most ``MAX_LINESEARCH_STEPS`` (20) evaluations,
   and falls back to the best step with sufficient decrease when it runs out;
4. w <- w + eta d; the line search's last value and gradient are the next
   iteration's (``optax.value_and_grad_from_state``), so the loss is evaluated
   once at the start and then once per line-search step, as optax does.

``torch.optim.LBFGS`` is a different method (strong-Wolfe search with other
interpolation, curvature-pair skipping), so the port does not use it.  Vectors
stay on the device; the line search's scalars (values, slopes, step sizes) are
NumPy scalars of the parameters' dtype, so its branches compare the same f32 (or
f64) numbers optax compares.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


# optax.lbfgs()'s line search: scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy='one') with its defaults (no step-size cap, tol 0)
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4            # sufficient decrease (Armijo)
CURV_RTOL = 0.9              # small curvature
APPROX_DEC_RTOL = 1e-6       # Hager-Zhang's approximate decrease, near a minimum
STEPSIZE_PRECISION = 1e-5    # a bracket this short ends the search
INCREASE_FACTOR = 2.0        # bracket search growth


class LinesearchResult(NamedTuple):
    stepsize: np.floating
    value: torch.Tensor        # loss and gradient at the step taken
    grad: torch.Tensor
    steps: int                 # loss + gradient evaluations


def _np_dtype(t: torch.Tensor):
    return {torch.float32: np.float32, torch.float64: np.float64}[t.dtype]


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with slope
    fpa at a (NaN where there is none; the caller then skips it)."""
    cc = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - cc * db, fc - fa - cc * dc
    aa = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    bb = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + np.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope fpa
    at a."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


def zoom_linesearch(value_and_grad: Callable, params: torch.Tensor, updates: torch.Tensor,
                    value, grad: torch.Tensor) -> LinesearchResult:
    """A step size along ``updates`` from ``params`` (value and gradient there
    given) that satisfies the sufficient-decrease and small-curvature tests,
    first trying 1: optax's ``scale_by_zoom_linesearch`` as ``optax.lbfgs()``
    configures it.  ``value_and_grad(w)`` returns (value, gradient) at w."""
    dt = _np_dtype(params)
    inf = dt(np.inf)
    value_init = dt(float(value))
    slope_init = dt(float(torch.dot(updates, grad)))

    def on_line(stepsize):
        v, g = value_and_grad(params + updates * float(stepsize))
        return dt(float(v)), v, g, dt(float(torch.dot(g, updates)))

    def decrease_error(stepsize, value_step, slope_step):
        err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value_step - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        err = np.maximum(np.minimum(np.maximum(approx, delta), err), dt(0.0))
        return inf if np.isnan(err) else err

    def curvature_error(slope_step):
        err = np.maximum(np.abs(slope_step) - CURV_RTOL * np.abs(slope_init), dt(0.0))
        return inf if np.isnan(err) else err

    # the optax state: the current point, the bracket [low, high], the cubic's
    # third point and the safe point (sufficient decrease only)
    count = 0
    stepsize, val, val_t, g_cur, slope = dt(0.0), value_init, value, grad, slope_init
    dec_err = inf
    interval_found = done = failed = False
    low = high = cubic_ref = dt(0.0)
    value_low = value_high = value_cubic_ref = value_init
    slope_low = slope_high = slope_init
    safe_stepsize, safe_value, safe_value_t, safe_grad = dt(0.0), value_init, value, grad

    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:      # algorithm 3.5: find a bracket
                new = dt(1.0) if count == 0 else dt(INCREASE_FACTOR * stepsize)
                v_new, v_new_t, g_new, s_new = on_line(new)
                dec_err = decrease_error(new, v_new, s_new)
                err = np.maximum(dec_err, curvature_error(s_new))
                if dec_err <= 0.0:
                    safe_stepsize, safe_value, safe_value_t, safe_grad = new, v_new, v_new_t, g_new
                set_high = bool(dec_err > 0.0) or (bool(v_new >= val) and count > 0)
                set_low = bool(s_new >= 0.0) and not set_high
                if set_low:
                    low, value_low, slope_low = new, v_new, s_new
                    high, value_high, slope_high = stepsize, val, slope
                else:
                    low, value_low, slope_low = stepsize, val, slope
                    high, value_high, slope_high = new, v_new, s_new
                done = bool(err <= 0.0)
                interval_found = set_high or set_low or done
                failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
                cubic_ref, value_cubic_ref = low, value_low
                stepsize, val, val_t, g_cur, slope = new, v_new, v_new_t, g_new, s_new
            else:                       # algorithm 3.6: zoom into the bracket
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = bool(delta <= STEPSIZE_PRECISION)
                m_cubic = _cubicmin(low, value_low, slope_low, high, value_high, cubic_ref,
                                    value_cubic_ref)
                m_quad = _quadmin(low, value_low, slope_low, high, value_high)
                if m_cubic > left + 0.2 * delta and m_cubic < right - 0.2 * delta:
                    middle = m_cubic
                elif m_quad > left + 0.1 * delta and m_quad < right - 0.1 * delta:
                    middle = m_quad
                else:
                    middle = (low + high) / 2.0
                v_mid, v_mid_t, g_mid, s_mid = on_line(middle)
                dec_err = decrease_error(middle, v_mid, s_mid)
                err = np.maximum(dec_err, curvature_error(s_mid))
                if dec_err <= 0.0 and v_mid < safe_value:
                    safe_stepsize, safe_value, safe_value_t, safe_grad = (middle, v_mid, v_mid_t,
                                                                          g_mid)
                done = bool(err <= 0.0)
                high_to_mid = bool(dec_err > 0.0) or bool(v_mid >= value_low)
                high_to_low = bool(s_mid * (high - low) >= 0.0) and not high_to_mid
                cubic_ref, value_cubic_ref = ((high, value_high) if high_to_mid or high_to_low
                                              else (low, value_low))
                if high_to_mid:
                    high, value_high, slope_high = middle, v_mid, s_mid
                elif high_to_low:
                    high, value_high, slope_high = low, value_low, slope_low
                if not high_to_mid:
                    low, value_low, slope_low = middle, v_mid, s_mid
                failed = (count + 1 >= MAX_LINESEARCH_STEPS
                          or (too_small and safe_stepsize > 0.0)) and not done
                stepsize, val, val_t, g_cur, slope = middle, v_mid, v_mid_t, g_mid, s_mid
            count += 1
            if failed and (safe_stepsize > 0.0 or np.isinf(dec_err)):
                # no step meets both tests: take the best one with sufficient
                # decrease (step 0 when even the first evaluation left the domain)
                stepsize, val_t, g_cur = safe_stepsize, safe_value_t, safe_grad
    return LinesearchResult(stepsize, val_t, g_cur, count)


class LBFGS:
    """The memory and two-loop recursion of ``optax.scale_by_lbfgs`` (with
    ``scale_init_precond``), over flat vectors of ``n`` parameters."""

    def __init__(self, n: int, memory_size: int = 20, device=None, dtype=torch.float32):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = int(memory_size)
        self.dw = torch.zeros(self.m, n, device=device, dtype=dtype)
        self.dg = torch.zeros(self.m, n, device=device, dtype=dtype)
        self.rho = torch.zeros(self.m, device=device, dtype=dtype)
        self.params = torch.zeros(n, device=device, dtype=dtype)
        self.grad = torch.zeros(n, device=device, dtype=dtype)
        self.count = 0

    def direction(self, params: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        """-P g at (params, grad), after the memory has taken the last step."""
        k, prev = self.count % self.m, (self.count - 1) % self.m
        if self.count > 0:
            dw, dg = params - self.params, grad - self.grad
            dot = torch.dot(dg, dw)
            self.dw[prev], self.dg[prev] = dw, dg
            self.rho[prev] = torch.where(dot == 0.0, torch.zeros_like(dot), 1.0 / dot)
            den = torch.dot(dg, dg)
            gamma = torch.where(den > 0.0, dot / den, torch.ones_like(den))
        else:
            self.dw[prev] = self.dg[prev] = self.rho[prev] = 0.0
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        order = [(k + i) % self.m for i in range(self.m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec - alphas[i] * self.dg[i]
        vec = gamma * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.dg[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.params, self.grad = params, grad
        self.count += 1
        return -vec


def lbfgs_iteration(value_and_grad: Callable, lbfgs: LBFGS, params: torch.Tensor, value,
                    grad: torch.Tensor):
    """One L-BFGS iteration from ``params`` with its ``value`` and ``grad``:
    (new params, the line search's :class:`LinesearchResult`, whose value and
    gradient are those at the new params)."""
    d = lbfgs.direction(params, grad)
    ls = zoom_linesearch(value_and_grad, params, d, value, grad)
    return params + d * float(ls.stepsize), ls
