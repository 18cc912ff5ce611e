"""The optimizers of the reference, written from their definitions.

Adam (Kingma and Ba; optax's form): m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
theta -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps), with the bias
corrections 1 - b^t taken in float32 as optax takes them.

Levenberg-Marquardt (matrix-free Gauss-Newton): solve (J^T J + lam I) delta =
-J^T r by exactly ``cg_iters`` conjugate-gradient iterations from delta = 0,
J v by forward-mode differentiation and J^T w by reverse mode, block by block
of residual rows; accept theta + delta if the loss falls (lam *= 1/2),
otherwise keep theta (lam *= 4); lam stays in [1e-12, 1e6].  Relinearising
in segments at an unchanged theta gives the same J, so segments change nothing
here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from . import loss as loss_mod


def adam(params, setup, steps: int, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """``steps`` Adam steps from ``params``: (losses at the start of each step,
    the first step's gradient, the parameters after the last step)."""
    theta = [(w.clone(), b.clone()) for w, b in params]
    m = [torch.zeros_like(p) for pair in theta for p in pair]
    v = [torch.zeros_like(p) for p in m]
    losses, first_grad = [], None
    for t in range(1, steps + 1):
        total, grads = loss_mod.loss_and_grad(theta, setup)
        losses.append(float(total))
        if first_grad is None:
            first_grad = grads
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
        flat = [p for pair in theta for p in pair]
        for i, (p, g) in enumerate(zip(flat, [g for pair in grads for g in pair])):
            m[i] = b1 * m[i] + (1.0 - b1) * g
            v[i] = b2 * v[i] + (1.0 - b2) * g * g
            p -= lr * (m[i] / bc1) / (torch.sqrt(v[i] / bc2) + eps)
    return losses, first_grad, theta


def _ravel(params):
    return torch.cat([p.reshape(-1) for pair in params for p in pair])


def _unravel(flat, like):
    out, at = [], 0
    for w, b in like:
        nw, nb = w.numel(), b.numel()
        out.append((flat[at:at + nw].view(w.shape), flat[at + nw:at + nw + nb]))
        at += nw + nb
    return out


def _residual_loss(flat, like, setup):
    return loss_mod.loss(_unravel(flat, like), setup)


def _jt(flat, like, setup, w_blocks):
    """J^T w, with w given block by block."""
    out = torch.zeros_like(flat)
    for blk, wb in zip(loss_mod.all_blocks(setup), w_blocks):
        x = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            r = loss_mod.rows(_unravel(x, like), setup, blk)
            out += torch.autograd.grad(r, x, wb)[0]
    return out


def _jtj(flat, like, setup, p):
    """J^T (J p): per block, one forward pass carrying the tangent p and the
    reverse pass of its primal with J p as the cotangent."""
    out = torch.zeros_like(flat)
    for blk in loss_mod.all_blocks(setup):
        x = flat.detach().requires_grad_(True)
        with torch.enable_grad(), fwAD.dual_level():
            r = loss_mod.rows(_unravel(fwAD.make_dual(x, p), like), setup, blk)
            primal, tangent = fwAD.unpack_dual(r)
            out += torch.autograd.grad(primal, x, tangent.detach())[0]
    return out


def lm(params, setup, steps: int, cg_iters: int, lam0: float) -> dict:
    """``steps`` LM iterations from ``params``: the loss and lam after each
    (``losses``, ``lams``), J^T r at the start (``grad``), J^T (J b) with
    b = -J^T r at the start, CG's first product (``jtjb``), and the parameters
    after the last iteration (``after``)."""
    like = params
    flat = _ravel(params).detach().clone()
    lam = torch.tensor(lam0, dtype=torch.float32, device=flat.device)
    losses, lams, first_grad, first_jtjb = [], [], None, None
    for _ in range(steps):
        with torch.no_grad():
            r_blocks = [loss_mod.rows(_unravel(flat, like), setup, blk)
                        for blk in loss_mod.all_blocks(setup)]
        loss = sum(torch.dot(r, r) for r in r_blocks)
        g = _jt(flat, like, setup, r_blocks)
        del r_blocks
        if first_grad is None:
            first_grad = _unravel(g, like)
        b = -g
        x = torch.zeros_like(b)
        p, res = b.clone(), b.clone()
        rz = torch.dot(b, b)
        for _ in range(int(cg_iters)):
            jtjp = _jtj(flat, like, setup, p)
            if first_jtjb is None:
                first_jtjb = _unravel(jtjp, like)
            ap = jtjp + lam * p
            alpha = rz / torch.clamp_min(torch.dot(p, ap), 1e-30)
            x = x + alpha * p
            res = res - alpha * ap
            rz_new = torch.dot(res, res)
            p = res + (rz_new / torch.clamp_min(rz, 1e-30)) * p
            rz = rz_new
        cand = flat + x
        cand_loss = _residual_loss(cand, like, setup)
        improved = bool(cand_loss < loss)
        if improved:
            flat, loss = cand, cand_loss
        lam = torch.clamp(lam * (0.5 if improved else 4.0), 1e-12, 1e6)
        losses.append(float(loss))
        lams.append(float(lam))
    return {"losses": losses, "lams": lams, "grad": first_grad, "jtjb": first_jtjb,
            "after": _unravel(flat, like)}
