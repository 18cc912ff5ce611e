"""Probe of the Fourier-feature kernels (csrc/ff_mlp.cu) on one NVIDIA GPU at the
contaminant shapes, with random data and weights: builds the kernels, holds K2-FF,
K7 and K8 against their plain versions on 192,000 points, and times them (CUDA
events, median of 5) at the full mesh (K2-FF, 9,906,624 points) and at one LM chunk
(K7 / K8, 619,200 points).  Run from the repository root: python3 scripts/probe_ff.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import math, time, statistics, subprocess
import torch
from varnet_tpu_torch.ops import build, fused_residual as fr, value_and_jac as vj
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
t0 = time.time(); build.load_library(); print("build", time.time() - t0)
for line in (build.build_dir() / "build.log").read_text().splitlines():
    if "ff_" in line and ("Compiling" in line) or ("registers" in line and "ff" in line) or "spill" in line:
        print(" ", line.strip())
def rel(a, b): return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
def ms(fn, n=5):
    fn(); torch.cuda.synchronize(); ts = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record(); torch.cuda.synchronize(); ts.append(s.elapsed_time(e))
    return statistics.median(ts)
torch.backends.cuda.matmul.allow_tf32 = False
dev = "cuda"; g = torch.Generator().manual_seed(0)
F, H = 128, 96
B = torch.cat([0.5 * torch.randn(3, 64, generator=g), 2.0 * torch.randn(3, 64, generator=g)], 1)
bt = ((2 * math.pi) * B.T).contiguous().to(dev)
params = [{"w": (torch.randn(a, b, generator=g) * math.sqrt(2 / (a + b))).to(dev), "b": (0.1 * torch.randn(b, generator=g)).to(dev)}
          for a, b in [(256, H), (H, H), (H, H), (H, 1)]]
def data_of(k, nq=64):
    P = k * nq
    xs = torch.stack([2 * torch.rand(P, generator=g), torch.rand(P, generator=g), torch.rand(P, generator=g)]).to(dev)
    flds = torch.rand(4, P, generator=g).to(dev) * 0.1
    tab = torch.rand(nq, 4, generator=g).to(dev)
    return fr.ResidualData(xs, flds, tab, torch.ones(3, device=dev), k, nq, 2, True, False, bt)
small = data_of(3000)
gr = torch.randn(small.k, generator=g).to(dev)
r, rp = fr.dir_residual_ff_fwd(params, small, "tanh"), fr.dir_residual_fwd_plain(params, small, "tanh")
gk, gp = fr.dir_residual_ff_bwd(params, small, "tanh", gr), fr.dir_residual_bwd_plain(params, small, "tanh", gr)
torch.cuda.synchronize()
print("K2-FF r", rel(r, rp), "g", max(rel(a[k], b[k]) for a, b in zip(gk, gp) for k in "wb"))
print("K2-FF small fwd", ms(lambda: fr.dir_residual_ff_fwd(params, small, "tanh")), "plain", ms(lambda: fr.dir_residual_fwd_plain(params, small, "tanh")))
print("K2-FF small bwd", ms(lambda: fr.dir_residual_ff_bwd(params, small, "tanh", gr)), "plain", ms(lambda: fr.dir_residual_bwd_plain(params, small, "tanh", gr)))
big = data_of(154791); grb = torch.randn(big.k, generator=g).to(dev)
print("K2-FF full fwd ms", ms(lambda: fr.dir_residual_ff_fwd(params, big, "tanh"), 3))
print("K2-FF full bwd ms", ms(lambda: fr.dir_residual_ff_bwd(params, big, "tanh", grb), 3))
del big
xs = small.xs; gg = torch.randn(4, xs.shape[1], generator=g).to(dev)
tan = [{k: torch.randn(v.shape, generator=g).to(dev) for k, v in l.items()} for l in params]
o, op = vj.ff_vj_fwd(params, xs, bt, "tanh"), vj.ff_vj_fwd_plain(params, xs, bt, "tanh")
b1, bp = vj.ff_vj_bwd(params, xs, bt, "tanh", gg), vj.ff_vj_bwd_plain(params, xs, bt, "tanh", gg)
d1, dp = vj.ff_vj_jvp(params, xs, bt, "tanh", tan), vj.ff_vj_jvp_plain(params, xs, bt, "tanh", tan)
torch.cuda.synchronize()
print("K7 fwd", max(rel(a, b) for a, b in zip(o, op)), "bwd", max(rel(a[k], b[k]) for a, b in zip(b1, bp) for k in "wb"), "K8", max(rel(a, b) for a, b in zip(d1, dp)))
chunk = data_of(154791 // 16 + 1).xs; gc = torch.randn(4, chunk.shape[1], generator=g).to(dev)
print("chunk P", chunk.shape[1])
print("K7 fwd chunk ms", ms(lambda: vj.ff_vj_fwd(params, chunk, bt, "tanh")))
print("K7 bwd chunk ms", ms(lambda: vj.ff_vj_bwd(params, chunk, bt, "tanh", gc)))
print("K8 chunk ms", ms(lambda: vj.ff_vj_jvp(params, chunk, bt, "tanh", tan)))
b2 = vj.ff_vj_bwd(params, chunk, bt, "tanh", gc); b3 = vj.ff_vj_bwd(params, chunk, bt, "tanh", gc)
print("deterministic", all(torch.equal(a[k], b[k]) for a, b in zip(b2, b3) for k in "wb"))
