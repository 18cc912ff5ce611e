"""Faults planted in the program, to show that the check catches them.

Each is a context manager that patches the port where the fault would arise,
on the kernel path and on the plain path alike:

    unchanged_state   an Adam or LM step returns its state unchanged
    half_batch        half of the test functions left out of the residual, the mean
                      taken over the rest (the kept rows scaled by sqrt 2)
    altered_answer    the interior residual altered where it is produced (+1%)
    altered_jvp       LM's J v altered where CG gets it (+1%)
    altered_vjp       LM's J^T w altered where the linearisation returns it (+1%)

A uniform 1% in J v or J^T w barely moves an LM step (CG solves the scaled
system for nearly the same step), so only numbers read off the products catch
those two.  A driver names the faults that its traffic can have (``FAULTS``).
A single card exchanges nothing between chips, so that fault has no place here.
"""

from __future__ import annotations

import contextlib
import math


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


@contextlib.contextmanager
def patched(*patches):
    """Each (object, name, value) set for the duration, then restored."""
    undo = [_patch(*p) for p in patches]
    try:
        yield
    finally:
        for u in reversed(undo):
            u()


def _residual_wrappers(transform):
    """Wrap the fused residual (Adam) and the weak-form contraction (LM) so
    that ``transform`` acts on r where it is produced."""
    from varnet_tpu_torch.train import gauss_newton, loss

    fused, weak = loss.fused_residual, gauss_newton.weak_residual

    def fused_fault(*a, **k):
        return transform(fused(*a, **k))

    def weak_fault(*a, **k):
        return transform(weak(*a, **k))

    return (loss, "fused_residual", fused_fault), (gauss_newton, "weak_residual", weak_fault)


def half_batch():
    import torch

    def drop(r):
        keep = torch.zeros_like(r)
        keep[: r.shape[0] // 2] = math.sqrt(2.0)
        return r * keep

    return patched(*_residual_wrappers(drop))


def altered_answer():
    return patched(*_residual_wrappers(lambda r: r * 1.01))


def unchanged_state():
    from varnet_tpu_torch import api
    from varnet_tpu_torch.train import optim

    make_lm_step = api.make_lm_step

    def frozen_lm_step(*a, **k):
        make_lm_step(*a, **k)
        return lambda state: state

    def frozen_adam_step(self):
        return None

    return patched((api, "make_lm_step", frozen_lm_step),
                    (optim.AdamF32BiasCorrection, "step", frozen_adam_step))


def altered_jvp():
    from varnet_tpu_torch.train import gauss_newton

    jvp = gauss_newton.jvp
    return patched((gauss_newton, "jvp", lambda *a, **k: jvp(*a, **k) * 1.01))


def altered_vjp():
    from varnet_tpu_torch.train import gauss_newton

    linearize = gauss_newton.linearize

    def faulty(closure, flat):
        r, pullback = linearize(closure, flat)
        return r, lambda w: pullback(w) * 1.01

    return patched((gauss_newton, "linearize", faulty))


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "altered_jvp": altered_jvp,
          "altered_vjp": altered_vjp}
