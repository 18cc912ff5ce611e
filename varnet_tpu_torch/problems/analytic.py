"""[Copy of ``varnet_tpu/problems/analytic.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_host.py`` holds the two bit-equal.]

Analytic advection-diffusion solutions.

The reference validates by closed-form solutions (SURVEY.md §4: "analytic
-solution examples as end-to-end tests"); this module is the shared library
behind our examples AND the unit tests — in particular the
residual-of-analytic-solution test, "the single most valuable test"
(SURVEY.md §4), which validates mesh, quadrature, N/dN and field evaluation
jointly without any training.

Each factory returns a dict with the ADPDE field callables plus ``c_ex``
and the analytic spatial gradient / time derivative (for residual tests).
"""

from __future__ import annotations

import numpy as np

from ..geometry.domain import Domain1D, RectangleDomain2D
from .adpde import ADPDE, MORVar


def steady_ad_1d(kappa: float = 0.05, vel: float = 1.0):
    """1-D steady advection-diffusion boundary layer (BASELINE config 1).

        v u_x - kappa u_xx = 0 on (0, 1),  u(0) = 0, u(1) = 1
        u(x) = (exp(v x / kappa) - 1) / (exp(v / kappa) - 1)

    Advection-dominated for small kappa — the sharp-front regime the
    weak-form loss is designed for (SURVEY.md §0 item 3).
    """
    pe = vel / kappa

    def c_ex(x, t=None):
        x = np.atleast_2d(x)[:, 0]
        return np.expm1(pe * x) / np.expm1(pe)

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)[:, 0]
        return (pe * np.exp(pe * x) / np.expm1(pe))[:, None]

    domain = Domain1D(0.0, 1.0)
    pde = ADPDE(domain, diff=kappa, vel=vel, source=0.0, bcs=[0.0, 1.0], c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def steady_adr_1d(kappa: float = 0.1, vel: float = 1.0, react: float = 2.0):
    """1-D steady advection-diffusion-REACTION (beyond-reference extension):

        v u_x - kappa u_xx + c u = s,  u(0) = u(1) = 0
        manufactured: u = sin(pi x),
        s = kappa pi^2 sin(pi x) + v pi cos(pi x) + c sin(pi x)
    """

    def c_ex(x, t=None):
        x1 = np.atleast_2d(x)[:, 0]
        return np.sin(np.pi * x1)

    def c_ex_grad(x, t=None):
        x1 = np.atleast_2d(x)[:, 0]
        return (np.pi * np.cos(np.pi * x1))[:, None]

    def source(x, t=None):
        x1 = np.atleast_2d(x)[:, 0]
        return (
            kappa * np.pi**2 * np.sin(np.pi * x1)
            + vel * np.pi * np.cos(np.pi * x1)
            + react * np.sin(np.pi * x1)
        )

    domain = Domain1D(0.0, 1.0)
    pde = ADPDE(domain, diff=kappa, vel=vel, source=source, react=react,
                bcs=[0.0, 0.0], c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def transient_ad_1d(kappa: float = 0.02, vel: float = 1.0, x0: float = 0.2,
                    t_final: float = 0.5, t_eps: float = 0.01):
    """1-D transient AD with a moving smoothed front (BASELINE config 2).

        u_t + v u_x - kappa u_xx = 0
        u(x, t) = 1/2 erfc((x - x0 - v t) / (2 sqrt(kappa (t + t_eps))))

    The erfc similarity solution of the infinite-domain problem; Dirichlet
    data on both ends and the IC are taken from the exact solution, so it
    remains exact on the truncated domain.
    """
    from scipy.special import erfc

    # t_eps shifts the similarity solution off its t=0 singularity; the
    # initial front width is ~2 sqrt(kappa * t_eps).

    def _u(x, t):
        sig = 2.0 * np.sqrt(kappa * (t + t_eps))
        return 0.5 * erfc((x - x0 - vel * t) / sig)

    def c_ex(x, t):
        return _u(np.atleast_2d(x)[:, 0], np.asarray(t))

    def c_ex_grad(x, t):
        x1 = np.atleast_2d(x)[:, 0]
        t = np.asarray(t)
        sig = 2.0 * np.sqrt(kappa * (t + t_eps))
        z = (x1 - x0 - vel * t) / sig
        return (-np.exp(-z * z) / (np.sqrt(np.pi) * sig))[:, None]

    def c_ex_dt(x, t):
        x1 = np.atleast_2d(x)[:, 0]
        t = np.asarray(t)
        sig = 2.0 * np.sqrt(kappa * (t + t_eps))
        z = (x1 - x0 - vel * t) / sig
        dz_dt = -vel / sig - (x1 - x0 - vel * t) * kappa / (sig**3) * 2.0
        return -np.exp(-z * z) / np.sqrt(np.pi) * dz_dt

    domain = Domain1D(0.0, 1.0)
    pde = ADPDE(
        domain,
        diff=kappa,
        vel=vel,
        source=0.0,
        t_interval=(0.0, t_final),
        bcs=[lambda x, t: c_ex(x, t), lambda x, t: c_ex(x, t)],
        ic=lambda x: _u(np.atleast_2d(x)[:, 0], 0.0),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": c_ex_dt}


def steady_ad_2d(kappa: float = 0.1, vel=(1.0, 0.5)):
    """2-D steady AD on the unit square with a manufactured solution
    (BASELINE config 3).

        u(x, y) = sin(pi x) sin(pi y)
        s = v . grad(u) - kappa lap(u)   (manufactured)
    """
    vx, vy = float(vel[0]), float(vel[1])

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        sx, cx = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([np.pi * cx * sy, np.pi * sx * cy], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -2.0 * np.pi**2 * c_ex(x)
        return vx * g[:, 0] + vy * g[:, 1] - kappa * lap

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=np.array([vx, vy]), source=source,
        bcs=0.0, c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def contaminant_transport_2d(
    kappa: float = 0.01,
    u_max: float = 1.0,
    t_final: float = 1.0,
    src_center=(0.3, 0.5),
    src_sigma: float = 0.06,
    src_t_off: float = 0.3,
):
    """2-D transient contaminant transport with a spatially varying velocity
    field (BASELINE config 4; reference: the T-RO cloaking case, SURVEY.md
    §0 item 7 — validated there against COMSOL FEM data that is not
    shipped, so no ``c_ex`` here).

    Channel [0,2]x[0,1]; parabolic (Poiseuille) shear flow
    v = (u_max * 4 y (1-y), 0); a Gaussian contaminant source near the
    inlet active for t < src_t_off; zero IC; zero Dirichlet BCs except the
    outflow (segment 1), which is left unconstrained (None).
    """
    cx, cy = float(src_center[0]), float(src_center[1])

    def vel(x, t=None):
        x = np.atleast_2d(x)
        vx = 4.0 * u_max * x[:, 1] * (1.0 - x[:, 1])
        return np.stack([vx, np.zeros_like(vx)], axis=-1)

    def source(x, t=None):
        x = np.atleast_2d(x)
        g = np.exp(
            -((x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2) / (2.0 * src_sigma**2)
        )
        if t is None:
            return g
        gate = 0.5 * (1.0 - np.tanh((np.asarray(t) - src_t_off) / 0.02))
        return g * gate

    domain = RectangleDomain2D((0.0, 0.0), (2.0, 1.0))
    pde = ADPDE(
        domain,
        diff=kappa,
        vel=vel,
        source=source,
        t_interval=(0.0, t_final),
        bcs=[0.0, None, 0.0, 0.0],  # bottom, outflow(right)=free, top, inlet
        ic=0.0,
    )
    return {"pde": pde, "c_ex": None, "c_ex_grad": None, "c_ex_dt": None}


def contaminant_inlet_2d(
    kappa: float = 0.03,
    u_max: float = 1.0,
    t_final: float = 1.0,
    inlet_center: float = 0.5,
    inlet_sigma: float = 0.12,
    t_on: float = 0.1,
    t_off: float = 0.5,
):
    """2-D transient contaminant transport, BOUNDARY-driven variant:
    contaminant enters through the INLET (left edge) as a time-gated
    Dirichlet concentration profile and is advected down the channel by
    the Poiseuille flow.  Same physics class as the volumetric-source
    config (shear transport, free outflow); unlike it, the nonzero inlet
    data drives the network the way the flagship's BCs do, avoiding the
    measured u=0 quasi-minimum of source-driven configs with homogeneous
    BC/IC (see DESIGN.md 'zero-data attractor').
    """

    def gate(t):
        # starts ~0 at t=0 (gate(0) < 1e-2) so the zero IC is consistent
        t = np.asarray(t, dtype=np.float64)
        return 0.5 * (np.tanh((t - t_on) / 0.04) - np.tanh((t - t_off) / 0.04))

    def g_inlet(x, t=None):
        x = np.atleast_2d(x)
        prof = np.exp(-((x[:, 1] - inlet_center) ** 2) / (2 * inlet_sigma**2))
        if t is None:
            return prof
        return prof * gate(t)

    def vel(x, t=None):
        x = np.atleast_2d(x)
        vx = 4.0 * u_max * x[:, 1] * (1.0 - x[:, 1])
        return np.stack([vx, np.zeros_like(vx)], axis=-1)

    domain = RectangleDomain2D((0.0, 0.0), (2.0, 1.0))
    pde = ADPDE(
        domain,
        diff=kappa,
        vel=vel,
        source=0.0,
        t_interval=(0.0, t_final),
        # bottom, outflow(right)=free, top, inlet(left)
        bcs=[0.0, None, 0.0, g_inlet],
        ic=0.0,
    )
    return {"pde": pde, "c_ex": None, "c_ex_grad": None, "c_ex_dt": None,
            "g_inlet": g_inlet}


def inverse_source_2d(kappa: float = 0.1, vel=(1.0, 0.5), n_obs: int = 400,
                      noise: float = 0.0, seed: int = 0):
    """Inverse source identification (BASELINE config 5 — stretch):
    recover the source field AND the solution jointly from observations.

    Manufactured ground truth: u*(x,y) = sin(pi x) sin(pi y) with
    s* = v . grad(u*) - kappa lap(u*).  The trainable source is a callable
    ``source_fn(phi, x, t)`` (see VarNet ctor); observations are u* samples
    on a uniform interior grid (optionally noisy).  Recovery quality is
    checked against BOTH u* and s*.
    """
    vx, vy = float(vel[0]), float(vel[1])

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        sx, cx = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([np.pi * cx * sy, np.pi * sx * cy], axis=-1)

    def s_true(x, t=None):
        g = c_ex_grad(x)
        lap = -2.0 * np.pi**2 * c_ex(x)
        return vx * g[:, 0] + vy * g[:, 1] - kappa * lap

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=np.array([vx, vy]), source=None,
        bcs=0.0, c_ex=c_ex,
    )

    # Observation grid (interior, excludes the boundary where u* = 0).
    m = int(np.sqrt(n_obs))
    g1 = np.linspace(0.0, 1.0, m + 2)[1:-1]
    xx, yy = np.meshgrid(g1, g1, indexing="ij")
    obs_x = np.stack([xx.ravel(), yy.ravel()], axis=-1)
    obs_u = c_ex(obs_x)
    if noise > 0:
        rng = np.random.default_rng(seed)
        obs_u = obs_u + noise * rng.standard_normal(obs_u.shape)

    return {
        "pde": pde,
        "c_ex": c_ex,
        "c_ex_grad": c_ex_grad,
        "c_ex_dt": None,
        "s_true": s_true,
        "obs_x": obs_x,
        "obs_u": obs_u,
    }


def mor_steady_ad_2d(kappa: float = 0.25, vels=(0.5, 1.0, 1.5, 2.0)):
    """2-D parametric (MOR) family with a closed form (SURVEY.md §0 item 1,
    §3.5; VERDICT r1 missing #3 asked for measured 2-D MOR evidence).

    Velocity v = (mu, 0) with the Peclet boundary layer in x modulated by
    sin(pi y):

        u*_mu(x, y) = f_mu(x) sin(pi y),
        f_mu(x) = expm1(mu x / kappa) / expm1(mu / kappa)

    f satisfies mu f' - kappa f'' = 0, so
        s = v . grad(u*) - kappa lap(u*) = kappa pi^2 u*.

    The solution family genuinely depends on mu (the layer sharpens with
    Peclet), so the amortized network must actually use its mu input.
    """

    def _f(x1, mu1):
        pe = mu1 / kappa
        return np.expm1(pe * x1) / np.expm1(pe)

    def c_ex(x, t=None, mu=None):
        x = np.atleast_2d(x)
        mu1 = mu[:, 0] if mu is not None else np.full(x.shape[0], vels[0])
        return _f(x[:, 0], mu1) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None, mu=None):
        x = np.atleast_2d(x)
        mu1 = mu[:, 0] if mu is not None else np.full(x.shape[0], vels[0])
        pe = mu1 / kappa
        fx = _f(x[:, 0], mu1)
        dfx = pe * np.exp(pe * x[:, 0]) / np.expm1(pe)
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([dfx * sy, np.pi * fx * cy], axis=-1)

    def vel(x, t=None, mu=None):
        n = np.atleast_2d(x).shape[0]
        v = mu[:, 0] if mu is not None else np.full(n, vels[0])
        return np.stack([v, np.zeros(n)], axis=-1)

    def source(x, t=None, mu=None):
        return kappa * np.pi**2 * c_ex(x, t, mu)

    def g_edge(x, t=None, mu=None):
        return c_ex(x, t, mu)

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=vel, source=source,
        bcs=[g_edge] * 4, c_ex=c_ex,
        mor=MORVar(samples=np.array([[v] for v in vels])),
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def mor_steady_ad_2d_hom(kappa: float = 0.25, vels=(0.5, 1.0, 1.5, 2.0)):
    """Parametric 2-D family with HOMOGENEOUS Dirichlet data — the honest
    target for hard-BC x MOR composition (DESIGN.md decision 18): g = 0
    carries no solution information, so the exact-imposition ansatz
    cannot leak c_ex (unlike :func:`mor_steady_ad_2d`, whose boundary
    data IS the solution restricted to the boundary).

        u*_mu(x, y) = sin(pi x) sin(pi y) (1 + mu x),   v = (mu, 0),
        s = mu du*/dx - kappa lap(u*)   (manufactured).
    """
    pi = np.pi

    def _mu1(x, mu):
        n = np.atleast_2d(x).shape[0]
        return mu[:, 0] if mu is not None else np.full(n, vels[0])

    def _parts(x, mu1):
        sx, cx = np.sin(pi * x[:, 0]), np.cos(pi * x[:, 0])
        sy = np.sin(pi * x[:, 1])
        cy = np.cos(pi * x[:, 1])
        return sx, cx, sy, cy, 1.0 + mu1 * x[:, 0]

    def c_ex(x, t=None, mu=None):
        x = np.atleast_2d(x)
        sx, _, sy, _, f = _parts(x, _mu1(x, mu))
        return sx * sy * f

    def c_ex_grad(x, t=None, mu=None):
        x = np.atleast_2d(x)
        mu1 = _mu1(x, mu)
        sx, cx, sy, cy, f = _parts(x, mu1)
        ux = (pi * cx * f + mu1 * sx) * sy
        uy = pi * sx * f * cy
        return np.stack([ux, uy], axis=-1)

    def source(x, t=None, mu=None):
        x = np.atleast_2d(x)
        mu1 = _mu1(x, mu)
        sx, cx, sy, _, f = _parts(x, mu1)
        ux = (pi * cx * f + mu1 * sx) * sy
        lap = (-2.0 * pi**2 * sx * f + 2.0 * pi * mu1 * cx) * sy
        return mu1 * ux - kappa * lap

    def vel(x, t=None, mu=None):
        n = np.atleast_2d(x).shape[0]
        v = mu[:, 0] if mu is not None else np.full(n, vels[0])
        return np.stack([v, np.zeros(n)], axis=-1)

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=vel, source=source, bcs=0.0, c_ex=c_ex,
        mor=MORVar(samples=np.array([[v] for v in vels])),
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def lshape_manufactured_2d(kappa: float = 0.05, vel=(1.0, 0.5)):
    """Steady AD on the non-convex L-shape with a MANUFACTURED solution
    (VERDICT r1 weak #4: the round-1 L-shape example had no acceptance
    criterion).  u* = sin(pi x) sin(pi y) vanishes on the four outer edges
    but NOT on the two inner (re-entrant) edges, so the per-edge Dirichlet
    machinery is genuinely exercised: edge 2 (the inner horizontal y = 0.5
    wall) and edge 3 (the inner vertical x = 0.5 wall) carry non-trivial
    g = u*.

    Vertex order: (0,0) (1,0) (1,.5) (.5,.5) (.5,1) (0,1); edge i runs from
    vertex i to i+1, so edges are: 0 bottom, 1 right(lower), 2 inner
    horizontal y=0.5, 3 inner vertical x=0.5, 4 top(left half), 5 left.
    """
    from ..geometry.domain import PolygonDomain2D

    vx, vy = float(vel[0]), float(vel[1])

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        sx, cx = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([np.pi * cx * sy, np.pi * sx * cy], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -2.0 * np.pi**2 * c_ex(x)
        return vx * g[:, 0] + vy * g[:, 1] - kappa * lap

    domain = PolygonDomain2D(np.array([
        [0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 0.5], [0.5, 1.0], [0.0, 1.0],
    ]))
    pde = ADPDE(
        domain, diff=kappa, vel=np.array([vx, vy]), source=source,
        bcs=[lambda x, t=None: c_ex(x)] * 6, c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": None}


def transient_ad_2d(kappa: float = 0.05, vel=(0.5, 0.25), t_final: float = 0.5):
    """2-D transient AD with a translating-decaying exact solution
    (BASELINE config 4 analytic variant; the flagship benchmark problem).

        u(x, y, t) = exp(-2 kappa pi^2 t) sin(pi (x - vx t)) sin(pi (y - vy t))

    satisfies u_t + v . grad(u) - kappa lap(u) = 0 with constant v; BCs on
    the unit square and the IC come from the exact solution.
    """
    vx, vy = float(vel[0]), float(vel[1])

    def _parts(x, t):
        x = np.atleast_2d(x)
        t = np.asarray(t, dtype=np.float64)
        wx = x[:, 0] - vx * t
        wy = x[:, 1] - vy * t
        amp = np.exp(-2.0 * kappa * np.pi**2 * t)
        return wx, wy, amp

    def c_ex(x, t):
        wx, wy, amp = _parts(x, t)
        return amp * np.sin(np.pi * wx) * np.sin(np.pi * wy)

    def c_ex_grad(x, t):
        wx, wy, amp = _parts(x, t)
        gx = amp * np.pi * np.cos(np.pi * wx) * np.sin(np.pi * wy)
        gy = amp * np.pi * np.sin(np.pi * wx) * np.cos(np.pi * wy)
        return np.stack([gx, gy], axis=-1)

    def c_ex_dt(x, t):
        wx, wy, amp = _parts(x, t)
        s_x, c_x = np.sin(np.pi * wx), np.cos(np.pi * wx)
        s_y, c_y = np.sin(np.pi * wy), np.cos(np.pi * wy)
        return amp * (
            -2.0 * kappa * np.pi**2 * s_x * s_y
            - np.pi * vx * c_x * s_y
            - np.pi * vy * s_x * c_y
        )

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain,
        diff=kappa,
        vel=np.array([vx, vy]),
        source=0.0,
        t_interval=(0.0, t_final),
        bcs=[lambda x, t: c_ex(x, t)] * 4,
        ic=lambda x: c_ex(x, np.zeros(np.atleast_2d(x).shape[0])),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad, "c_ex_dt": c_ex_dt}


def steady_ad_3d(kappa: float = 0.1, vel=(1.0, 0.5, 0.25)):
    """3-D steady AD on the unit cube with a manufactured solution
    (beyond-reference: the reference stops at 2-D — SURVEY.md §2.1 #4;
    the assembly/loss/kernel layers here are dimension-generic, so 3-D
    costs only a box domain).

        u(x, y, z) = sin(pi x) sin(pi y) sin(pi z)
        s = v . grad(u) - kappa lap(u)   (manufactured)
    """
    from ..geometry.domain import BoxDomain3D

    v = np.asarray(vel, dtype=np.float64)

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return (np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
                * np.sin(np.pi * x[:, 2]))

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        s = np.sin(np.pi * x)
        c = np.cos(np.pi * x)
        return np.pi * np.stack(
            [c[:, 0] * s[:, 1] * s[:, 2],
             s[:, 0] * c[:, 1] * s[:, 2],
             s[:, 0] * s[:, 1] * c[:, 2]], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -3.0 * np.pi**2 * c_ex(x)
        return g @ v - kappa * lap

    domain = BoxDomain3D((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    pde = ADPDE(domain, diff=kappa, vel=v, source=source, bcs=0.0,
                c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def obstacle_manufactured_2d(kappa: float = 0.05, vel=(1.0, 0.5)):
    """Steady AD on a square with a square HOLE (internal obstacle
    boundary — beyond-reference: the geometry of the cloaking/obstacle
    applications; PolygonDomain2D(holes=...)).

        Omega = [0,1]^2 minus [0.375, 0.625]^2
        u(x, y) = sin(pi x) sin(pi y)
        s = v . grad(u) - kappa lap(u)   (manufactured)

    u vanishes on the four outer edges but is non-trivial on the four
    hole edges (segments 4-7), so the obstacle boundary genuinely drives
    the solution (zero-data-attractor-safe, like lshape_manufactured_2d).
    """
    from ..geometry.domain import PolygonDomain2D

    vx, vy = float(vel[0]), float(vel[1])

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        sx, cx = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([np.pi * cx * sy, np.pi * sx * cy], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -2.0 * np.pi**2 * c_ex(x)
        return vx * g[:, 0] + vy * g[:, 1] - kappa * lap

    lo, hi = 0.375, 0.625
    domain = PolygonDomain2D(
        np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
        holes=[np.array([[lo, lo], [hi, lo], [hi, hi], [lo, hi]])],
    )
    pde = ADPDE(domain, diff=kappa, vel=np.array([vx, vy]), source=source,
                bcs=[lambda x, t=None: c_ex(x)] * 8, c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def steady_ad_prism(kappa: float = 0.05, vel=(1.0, 0.5, 0.25)):
    """Steady AD on an L-SHAPED PRISM (non-convex 3-D geometry:
    PolygonDomain2D cross-section extruded along z — PrismDomain3D;
    beyond-reference on two axes at once, non-convexity and dimension).

        Omega = L-shape([0,1]^2 minus (0.5,1]x(0.5,1]) x [0,1]
        u(x, y, z) = sin(pi x) sin(pi y) sin(pi z)
        s = v . grad(u) - kappa lap(u)   (manufactured)

    Mirrors lshape_manufactured_2d: u vanishes on the four OUTER walls and
    both caps but is non-trivial on the two re-entrant inner walls
    (x = 0.5 and y = 0.5), so the per-wall Dirichlet machinery is
    genuinely exercised AND the problem is boundary-driven.  (An earlier
    all-zero-data variant on the [0,2]^2 footprint hit the zero-data
    attractor — a known trap — and trained to u = 0.)
    """
    from ..geometry.domain import PrismDomain3D

    v = np.asarray(vel, dtype=np.float64)

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return (np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
                * np.sin(np.pi * x[:, 2]))

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        s = np.sin(np.pi * x)
        c = np.cos(np.pi * x)
        return np.pi * np.stack(
            [c[:, 0] * s[:, 1] * s[:, 2],
             s[:, 0] * c[:, 1] * s[:, 2],
             s[:, 0] * s[:, 1] * c[:, 2]], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -3.0 * np.pi**2 * c_ex(x)
        return g @ v - kappa * lap

    domain = PrismDomain3D(np.array([
        [0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 0.5],
        [0.5, 1.0], [0.0, 1.0],
    ]), 0.0, 1.0)
    pde = ADPDE(domain, diff=kappa, vel=v, source=source,
                bcs=[lambda x, t=None: c_ex(x)] * 8, c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def transient_ad_3d(kappa: float = 0.1, vel=(1.0, 0.5, 0.25),
                    t_final: float = 0.5):
    """3-D transient AD on the unit cube with a manufactured solution
    (exercises the 4-D tensor-product quadrature tables, nQ = (2q)^4).

        u(x, t) = sin(pi x) sin(pi y) sin(pi z) exp(-t)
        s = u_t + v . grad(u) - kappa lap(u)   (manufactured)
    """
    from ..geometry.domain import BoxDomain3D

    v = np.asarray(vel, dtype=np.float64)

    def c_ex(x, t):
        x = np.atleast_2d(x)
        t = np.asarray(t)
        return (np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])
                * np.sin(np.pi * x[:, 2]) * np.exp(-t))

    def c_ex_grad(x, t):
        x = np.atleast_2d(x)
        s = np.sin(np.pi * x)
        c = np.cos(np.pi * x)
        e = np.exp(-np.asarray(t))
        return np.pi * e[..., None] * np.stack(
            [c[:, 0] * s[:, 1] * s[:, 2],
             s[:, 0] * c[:, 1] * s[:, 2],
             s[:, 0] * s[:, 1] * c[:, 2]], axis=-1)

    def c_ex_dt(x, t):
        return -c_ex(x, t)

    def source(x, t):
        g = c_ex_grad(x, t)
        lap = -3.0 * np.pi**2 * c_ex(x, t)
        return c_ex_dt(x, t) + g @ v - kappa * lap

    domain = BoxDomain3D((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=v, source=source, bcs=0.0,
        t_interval=(0.0, float(t_final)),
        ic=lambda x: c_ex(x, np.zeros(np.atleast_2d(x).shape[0])),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": c_ex_dt}


def steady_ad_1d_neumann(kappa: float = 0.2, vel: float = 1.0):
    """1-D steady AD with a Dirichlet left end and a NEUMANN right end
    (beyond-reference: the reference is Dirichlet-only — NeumannBC).

        u(x) = sin(pi x / 3)  on [0, 1]
        u(0) = 0,   kappa u'(1) = kappa pi/3 cos(pi/3)
        s = v u' - kappa u''   (manufactured)
    """
    from .adpde import NeumannBC

    k3 = np.pi / 3.0

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(k3 * x[:, 0])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        return (k3 * np.cos(k3 * x[:, 0]))[:, None]

    def source(x, t=None):
        x = np.atleast_2d(x)[:, 0]
        return kappa * k3**2 * np.sin(k3 * x) + vel * k3 * np.cos(k3 * x)

    flux_right = float(kappa * k3 * np.cos(k3))
    pde = ADPDE(Domain1D(0.0, 1.0), diff=kappa, vel=vel, source=source,
                bcs=[0.0, NeumannBC(flux_right)], c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def steady_ad_2d_neumann(kappa: float = 0.1, vel=(1.0, 0.5)):
    """2-D steady AD on the unit square, Dirichlet on three edges and
    NEUMANN flux data on the right edge x = 1 (beyond-reference).

        u(x, y) = sin(pi x) sin(pi y)
        kappa du/dn |_{x=1} = kappa pi cos(pi) sin(pi y)
        s = v . grad(u) - kappa lap(u)   (manufactured)

    Segment order (RectangleDomain2D): bottom, right, top, left.
    """
    from .adpde import NeumannBC

    vx, vy = float(vel[0]), float(vel[1])

    def c_ex(x, t=None):
        x = np.atleast_2d(x)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1])

    def c_ex_grad(x, t=None):
        x = np.atleast_2d(x)
        sx, cx = np.sin(np.pi * x[:, 0]), np.cos(np.pi * x[:, 0])
        sy, cy = np.sin(np.pi * x[:, 1]), np.cos(np.pi * x[:, 1])
        return np.stack([np.pi * cx * sy, np.pi * sx * cy], axis=-1)

    def source(x, t=None):
        g = c_ex_grad(x)
        lap = -2.0 * np.pi**2 * c_ex(x)
        return vx * g[:, 0] + vy * g[:, 1] - kappa * lap

    def flux_right(x, t=None):
        # n = +e_x on the right edge: kappa * du/dx (1, y)
        x = np.atleast_2d(x)
        return kappa * np.pi * np.cos(np.pi) * np.sin(np.pi * x[:, 1])

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=kappa, vel=np.array([vx, vy]), source=source,
        bcs=[0.0, NeumannBC(flux_right), 0.0, 0.0], c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def burgers_1d_steady(nu: float = 0.07, a: float = 1.0):
    """1-D STEADY viscous Burgers standing shock (beyond-reference:
    nonlinear advection via ``ADPDE(nl_adv=...)`` — the reference is
    strictly linear).

        u u_x - nu u_xx = 0  on (0, 1)
        u(x) = -a tanh(a (x - 1/2) / (2 nu))

    A viscous kink of width ~nu/a centered at x = 1/2 — the sharp-front
    regime the weak form targets, now with the front set by the solution
    itself rather than the data.
    """
    k = a / (2.0 * nu)

    def c_ex(x, t=None):
        x1 = np.atleast_2d(x)[:, 0]
        return -a * np.tanh(k * (x1 - 0.5))

    def c_ex_grad(x, t=None):
        x1 = np.atleast_2d(x)[:, 0]
        return (-a * k / np.cosh(k * (x1 - 0.5)) ** 2)[:, None]

    domain = Domain1D(0.0, 1.0)
    pde = ADPDE(domain, diff=nu, vel=0.0, source=0.0, nl_adv=1.0,
                bcs=[float(c_ex([[0.0]])[0]), float(c_ex([[1.0]])[0])],
                c_ex=c_ex)
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": None}


def burgers_1d_transient(nu: float = 0.05, a: float = 0.4, c: float = 0.6,
                         x0: float = 0.25, t_final: float = 0.8):
    """1-D transient viscous Burgers traveling front (beyond-reference).

        u_t + u u_x - nu u_xx = 0
        u(x, t) = c - a tanh(a (x - x0 - c t) / (2 nu))

    The tanh traveling wave: a front of height 2a moving at the mean
    speed c (check: u_t + u u_x = (u - c) u' = -a tanh(.) u' = nu u'').
    Dirichlet data on both ends and the IC are taken from the exact
    solution, so it remains exact on the truncated domain.
    """
    k = a / (2.0 * nu)

    def c_ex(x, t):
        x1 = np.atleast_2d(x)[:, 0]
        t = np.asarray(t)
        return c - a * np.tanh(k * (x1 - x0 - c * t))

    def c_ex_grad(x, t):
        x1 = np.atleast_2d(x)[:, 0]
        t = np.asarray(t)
        return (-a * k / np.cosh(k * (x1 - x0 - c * t)) ** 2)[:, None]

    def c_ex_dt(x, t):
        x1 = np.atleast_2d(x)[:, 0]
        t = np.asarray(t)
        return a * k * c / np.cosh(k * (x1 - x0 - c * t)) ** 2

    domain = Domain1D(0.0, 1.0)
    pde = ADPDE(
        domain, diff=nu, vel=0.0, source=0.0, nl_adv=1.0,
        t_interval=(0.0, float(t_final)),
        bcs=[lambda x, t: c_ex(x, t), lambda x, t: c_ex(x, t)],
        ic=lambda x: c_ex(x, np.zeros(np.atleast_2d(x).shape[0])),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": c_ex_dt}


def burgers_2d_manufactured(nu: float = 0.1, b=(1.0, 1.0),
                            t_final: float = 0.5):
    """2-D transient scalar Burgers-type equation, manufactured solution
    (beyond-reference; exercises nl_adv with a genuine [d] direction).

        u_t + u (b . grad u) - nu lap u = s   on (0,1)^2
        u(x, y, t) = exp(-t) sin(pi x) sin(pi y),   s manufactured
    """
    b = np.asarray(b, dtype=np.float64)

    def c_ex(x, t):
        x = np.atleast_2d(x)
        t = np.asarray(t)
        return np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) * np.exp(-t)

    def c_ex_grad(x, t):
        x = np.atleast_2d(x)
        t = np.asarray(t)
        e = np.exp(-t)
        return np.pi * np.stack(
            [np.cos(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]),
             np.sin(np.pi * x[:, 0]) * np.cos(np.pi * x[:, 1])], axis=-1
        ) * np.reshape(e, (-1, 1) if np.ndim(e) else (1, 1))

    def c_ex_dt(x, t):
        return -c_ex(x, t)

    def source(x, t):
        u = c_ex(x, t)
        g = c_ex_grad(x, t)
        lap = -2.0 * np.pi**2 * u
        return c_ex_dt(x, t) + u * (g @ b) - nu * lap

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=nu, vel=np.zeros(2), source=source, nl_adv=b,
        t_interval=(0.0, float(t_final)), bcs=0.0,
        ic=lambda x: c_ex(x, np.zeros(np.atleast_2d(x).shape[0])),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": c_ex_dt}


def burgers_2d_front(nu: float = 0.05, amp: float = 0.4, speed: float = 0.5,
                     x0: float = 0.4, bvec=(1.0, 1.0), t_final: float = 0.4):
    """2-D viscous Burgers-type planar traveling front — a TRUE analytic
    nonlinear solution (no manufactured source; beyond-reference).

    For u_t + u (b . grad u) - nu lap u = 0, the planar-wave ansatz
    u = f(e.x - s t) with e = b/|b| reduces to the 1-D Burgers ODE with
    effective advection beta = |b|:  (beta f - s) f' = nu f''.  The tanh
    kink solves it when s = beta*speed and k = beta*amp/(2 nu):

        u(x, t) = speed - amp tanh(k (e.x - x0 - beta speed t))

    a diagonal front of height 2 amp moving at normal speed beta*speed.
    """
    b = np.asarray(bvec, dtype=np.float64)
    beta = float(np.linalg.norm(b))
    e = b / beta
    k = beta * amp / (2.0 * nu)

    def _xi(x, t):
        x = np.atleast_2d(x)
        return x @ e - x0 - beta * speed * np.asarray(t)

    def c_ex(x, t):
        return speed - amp * np.tanh(k * _xi(x, t))

    def c_ex_grad(x, t):
        sech2 = 1.0 / np.cosh(k * _xi(x, t)) ** 2
        return (-amp * k * sech2)[..., None] * e

    def c_ex_dt(x, t):
        sech2 = 1.0 / np.cosh(k * _xi(x, t)) ** 2
        return amp * k * beta * speed * sech2

    domain = RectangleDomain2D((0.0, 0.0), (1.0, 1.0))
    pde = ADPDE(
        domain, diff=nu, vel=np.zeros(2), source=0.0, nl_adv=b,
        t_interval=(0.0, float(t_final)),
        bcs=[lambda x, t: c_ex(x, t)] * 4,
        ic=lambda x: c_ex(x, np.zeros(np.atleast_2d(x).shape[0])),
        c_ex=c_ex,
    )
    return {"pde": pde, "c_ex": c_ex, "c_ex_grad": c_ex_grad,
            "c_ex_dt": c_ex_dt}
