#!/usr/bin/env python3
"""training/optim.AdamW (optax.adamw's form) on the card: which elementwise
op rounds differently on the card than on the CPU, whether 20 steps of the
optimizer are bit-equal card against CPU, and one optimizer step's time at
a model's full trees beside torch.optim.AdamW (foreach) and the per-leaf
loop that was AdamW's first form.

    python3 chip_adamw.py [hamer|kpfusion]

Needs a CUDA card. Seeded random leaves, moments and gradients; times by
CUDA events with the host's enqueue time, then one step of each under
torch.profiler (device kernels and their device ms).
"""
import sys
import time

import numpy as np
import torch

from hamer_yolo_tpu_torch.training.optim import AdamW, _f32_bias_correction, named_leaves

SHAPES = [(1280, 3840), (3840,), (7, 3, 3), (1,)]


def op_check(rng):
    """Each op of the update on the card against the CPU, element by element."""
    xs = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ys = [np.abs(rng.standard_normal(s)).astype(np.float32) + 0.5 for s in SHAPES]
    c = _f32_bias_correction(0.999, 3)
    ops = {
        "foreach mul scalar": lambda a, b, d: torch._foreach_mul(a, 0.1),
        "foreach mul list": lambda a, b, d: torch._foreach_mul(a, b),
        "foreach add list": lambda a, b, d: torch._foreach_add(a, b),
        "foreach add scalar": lambda a, b, d: torch._foreach_add(a, 1e-8),
        "foreach div tensor": lambda a, b, d: torch._foreach_div(a, torch.full((), c, device=d)),
        "plain div tensor": lambda a, b, d: [x / torch.full((), c, device=d) for x in a],
        "foreach div list": lambda a, b, d: torch._foreach_div(a, b),
        "plain div list": lambda a, b, d: [x / y for x, y in zip(a, b)],
        "foreach sqrt": lambda a, b, d: torch._foreach_sqrt(b),
        "plain sqrt": lambda a, b, d: [torch.sqrt(x) for x in b],
        "f64 sqrt rounded to f32": lambda a, b, d: [torch.sqrt(x.double()).float() for x in b],
    }
    for name, f in ops.items():
        out = {}
        for d in ("cuda", "cpu"):
            out[d] = [t.cpu() for t in f([torch.tensor(x, device=d) for x in xs],
                                         [torch.tensor(y, device=d) for y in ys], d)]
        bad = sum(int((x != y).sum()) for x, y in zip(out["cuda"], out["cpu"]))
        print(f"{name}: {bad} of {sum(x.numel() for x in out['cpu'])} differ", flush=True)


def loop_step(ps, states, t, lr=1e-5, wd=1e-4, b1=0.9, b2=0.999, eps=1e-8):
    """AdamW's first form: the same update as a Python loop over the leaves."""
    f32 = np.float32
    for p, (mu, nu) in zip(ps, states):
        g = p.grad
        mu.mul_(float(f32(b1))).add_(g * float(f32(1 - b1)))
        nu.mul_(float(f32(b2))).add_((g * g) * float(f32(1 - b2)))
        c1 = torch.full((), _f32_bias_correction(b1, t), dtype=p.dtype, device=p.device)
        c2 = torch.full((), _f32_bias_correction(b2, t), dtype=p.dtype, device=p.device)
        u = (mu / c1) / (torch.sqrt(nu / c2) + float(f32(eps)))
        u = u + p * float(f32(wd))
        p.data.add_(u * float(-f32(lr)))


def bit_check(rng):
    """20 steps of each form on the card against the CPU, from the same leaves."""
    start = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[(1e-3 * rng.standard_normal(s)).astype(np.float32) for s in SHAPES]
             for _ in range(20)]
    for form in ("foreach", "loop"):
        res = {}
        for d in ("cuda", "cpu"):
            ps = [torch.tensor(a, device=d, requires_grad=True) for a in start]
            opt = AdamW(ps, lr=1e-5, weight_decay=1e-4)
            states = [(torch.zeros_like(p), torch.zeros_like(p)) for p in ps]
            for t, gs in enumerate(grads, 1):
                for p, g in zip(ps, gs):
                    p.grad = torch.tensor(g, device=d)
                if form == "foreach":
                    opt.step()
                else:
                    with torch.no_grad():
                        loop_step(ps, states, t)
            res[d] = [p.detach().cpu() for p in ps]
        bad = sum(int((x != y).sum()) for x, y in zip(res["cuda"], res["cpu"]))
        ulps = max(float(((x - y).abs() / torch.from_numpy(np.spacing(np.abs(y.numpy())))).max())
                   for x, y in zip(res["cuda"], res["cpu"]))
        print(f"AdamW {form} 20 steps: {bad} params differ card vs CPU, worst {ulps:.2f} ulp",
              flush=True)


def timing(model):
    """One optimizer step of each form at ``model``'s full trees, in turns."""
    from hamer_yolo_tpu_torch.models.hamer import HamerConfig
    from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import KPFusionConfig
    from hamer_yolo_tpu_torch.training import train_hamer as TH
    from hamer_yolo_tpu_torch.training import train_kpfusion_rgbd as TK

    dev = torch.device("cuda")
    if model == "hamer":
        state = TH.init_train_state(torch.Generator(dev).manual_seed(0), HamerConfig())
        trees, ports = (state.params, state.disc_params), [state.opt, state.disc_opt]
    else:
        state = TK.init_train_state(torch.Generator(dev).manual_seed(0), KPFusionConfig())
        trees, ports = (state.params,), [state.opt]
    leaves = [t for tree in trees for _, t in named_leaves(tree)]
    g = torch.Generator(dev).manual_seed(1)
    for t in leaves:
        t.grad = 1e-3 * torch.randn(t.shape, generator=g, device=dev)
    print(f"{model} trees: {len(leaves)} leaves, {sum(t.numel() for t in leaves):,} parameters")
    torch_opts = [torch.optim.AdamW([t for _, t in named_leaves(tr)], lr=1e-5, weight_decay=1e-4)
                  for tr in trees]
    loop_states = [(torch.zeros_like(p), torch.zeros_like(p)) for p in leaves]
    count = [0]

    def loop():
        count[0] += 1
        with torch.no_grad():
            loop_step(leaves, loop_states, count[0])

    forms = {"port foreach": lambda: [o.step() for o in ports],
             "torch.optim.AdamW (foreach)": lambda: [o.step() for o in torch_opts],
             "port per-leaf loop (first form)": loop}
    for f in forms.values():
        f()
    torch.cuda.synchronize()
    for _ in range(2):
        for name, f in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            f()
            b.record()
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            print(f"optimizer step, {name}: {a.elapsed_time(b):.2f} ms (CUDA events), host "
                  f"{host:.2f} ms to enqueue", flush=True)
    for name, f in forms.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            f()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        print(f"optimizer step, {name}: {len(ev)} device kernels, "
              f"{sum(e.device_time for e in ev) / 1e3:.2f} device ms (torch.profiler)", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("chip_adamw.py needs a CUDA card")
        return 1
    rng = np.random.default_rng(10)
    op_check(rng)
    bit_check(rng)
    timing(argv[0] if argv else "hamer")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
