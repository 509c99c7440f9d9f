#!/usr/bin/env python3
"""Check the cluster routes of the micro-blocked and no-swap panel kernels on
one CUDA card, quickly.

    python3 check_panel_routes.py           # both kernels
    python3 check_panel_routes.py noswap    # the no-swap kernel only

Builds csrc/panel_lu.cu, csrc/panel_lu_micro.cu and csrc/panel_lu_noswap.cu
(printing each build's ptxas lines), holds both kernels on their cluster
and grid routes bitwise against their plain versions (micro 1 to 64 on
tall, fat and tiny panels; no-swap masks from none to 97% of the rows
taken, ties and NaN, explicit plans), then times both routes of both
kernels per main-path panel in turns beside csrc/panel_lu.cu and the
library (CUDA events, median of 7 rounds).  Exits non-zero if a build
fails or any case disagrees.  ``chip_smoke.py`` covers the same ground in
full; this is the short check after editing one of the panel sources.
"""

import json
import sys
import time

MICRO_SHAPES = ((1000, 100), (777, 130), (130, 300), (1536, 512), (64, 40), (40, 64), (5, 3))
NOSWAP_SHAPES = ((1000, 100), (777, 130), (1536, 512), (300, 64), (6, 4), (513, 200), (130, 300))


def bits(t):
    import torch

    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def build(noswap_only):
    from recursivefactorization_jl_tpu_torch.ops import _kernels

    t0 = time.time()
    try:
        _kernels.build(["panel_lu", "panel_lu_micro", "panel_lu_noswap"])
    finally:
        for k, v in _kernels.BUILD_LOG.items():
            print(json.dumps({"build": k, "rc": v["rc"], "s": v["seconds"]}))
            for ln in v["log"].splitlines():
                if noswap_only and not any(x in ln for x in ("noswap_chain", "registers", "spill")):
                    continue
                if any(x in ln for x in ("error", "registers", "spill", "Compiling entry",
                                         "warning")):
                    print("  ", ln.strip()[:220])
    print("build", time.time() - t0, flush=True)


def check_micro(gen):
    """Both micro wrappers on the cluster route and the staged one on the
    grid route against micro_blocked_lu; returns the failures."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        micro_plan,
        panel_factor_basic_cuda,
        panel_factor_shadow_cuda,
    )
    from recursivefactorization_jl_tpu_torch.ops.unblocked import micro_blocked_lu

    bad = 0
    for (m, w) in MICRO_SHAPES:
        for dt in (torch.float32, torch.float64):
            for micro in (1, 4, 8, 12, 16, 32, 64):
                for pivot in (True, False):
                    X = torch.randn(m, w, generator=gen, dtype=dt)
                    if not pivot:
                        X += max(m, w) * torch.eye(m, w, dtype=dt)
                    X[:, min(5, w - 1)] = 0
                    A = X.to("cuda")
                    mc = min(micro, m, w)
                    f, piv, perm, info = micro_blocked_lu(A, pivot, mc)
                    for wr, blk in ((panel_factor_shadow_cuda, 0), (panel_factor_basic_cuda, 0),
                                    (panel_factor_shadow_cuda, -1)):
                        P = A.clone()
                        try:
                            kp, kperm, ki = wr(P, pivot, micro, block=blk)
                            torch.cuda.synchronize()
                            ok = (torch.equal(kp, piv) and torch.equal(kperm, perm)
                                  and int(ki) == int(info) and torch.equal(bits(P), bits(f)))
                        except RuntimeError as e:
                            ok = False
                            print("ERR", repr(e)[:300])
                        if not ok:
                            bad += 1
                            print(json.dumps({"micro_bad": [m, w], "dt": str(dt), "micro": micro,
                                              "pivot": pivot, "wr": wr.__name__, "blk": blk,
                                              "plan": micro_plan(m, w, dt, mc, block=blk)}),
                                  flush=True)
    print("micro done bad", bad, flush=True)
    return bad


def check_noswap(gen):
    """The no-swap wrapper with the live count, without it, on the grid
    route and with an explicit plan against unblocked_lu_noswap; returns
    the failures."""
    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import noswap_plan, panel_factor_noswap_cuda
    from recursivefactorization_jl_tpu_torch.ops.unblocked import unblocked_lu_noswap

    bad = 0
    for (m, w) in NOSWAP_SHAPES:
        for dt in (torch.float32, torch.float64):
            for share in (0.0, 0.3, 0.5, 0.97):
                for pivot in (True, False):
                    for name in ("randn", "ties", "nan"):
                        if name != "randn" and not pivot:
                            continue
                        X = (torch.randint(-2, 3, (m, w), generator=gen).to(dt) if name == "ties"
                             else torch.randn(m, w, generator=gen, dtype=dt))
                        if name == "nan":
                            X[m // 3, 2] = X[m // 2, 2] = float("nan")
                        X[:, min(5, w - 1)] = 0
                        A = X.to("cuda")
                        used0 = torch.zeros(m, dtype=torch.int32)
                        taken = int(share * m)
                        used0[torch.randperm(m, generator=gen)[:taken]] = 1
                        used0 = used0.to("cuda")
                        f, prow, used, info = unblocked_lu_noswap(A, used0, pivot)
                        for blk, live in ((0, m - taken), (0, None), (-1, None), (8, m - taken)):
                            kw = dict(live=live, block=blk)
                            if blk > 0:
                                kw["cluster"] = 4 if m - taken >= 4 else 1
                            P = A.clone()
                            try:
                                kp, ku, ki = panel_factor_noswap_cuda(P, used0, pivot, **kw)
                                torch.cuda.synchronize()
                                nanP, nanf = torch.isnan(P), torch.isnan(f)
                                ok = (torch.equal(kp, prow) and torch.equal(ku, used)
                                      and int(ki) == int(info) and torch.equal(nanP, nanf)
                                      and torch.equal(bits(P.masked_fill(nanP, 0)),
                                                      bits(f.masked_fill(nanf, 0))))
                            except RuntimeError as e:
                                ok = False
                                print("ERR", repr(e)[:300])
                            if not ok:
                                bad += 1
                                print(json.dumps({
                                    "noswap_bad": [m, w], "dt": str(dt), "share": share,
                                    "pivot": pivot, "name": name, "blk": blk, "live": live,
                                    "plan": noswap_plan(m, w, dt, live=live, block=blk,
                                                        cluster=kw.get("cluster", 0))}),
                                    flush=True)
    print("noswap done bad", bad, flush=True)
    return bad


def round_robin(fns, setup, rounds=7):
    """Median CUDA-event ms of each callable, one round timing each in
    turn, after one warm round; ``setup`` runs before each timing."""
    import torch

    ts = {k: [] for k in fns}
    for r in range(rounds + 1):
        for k, fn in fns.items():
            setup()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            if r:
                ts[k].append(e0.elapsed_time(e1))
    return {k: sorted(v)[len(v) // 2] for k, v in ts.items()}


def timing(gen):
    import torch

    from recursivefactorization_jl_tpu_torch.ops.panel import (
        micro_plan,
        noswap_plan,
        panel_factor_basic_cuda,
        panel_factor_cuda,
        panel_factor_noswap_cuda,
        panel_factor_shadow_cuda,
    )

    for (m, w) in ((1536, 512), (4096, 512)):
        X = torch.randn(m, w, generator=gen).to("cuda")
        P = torch.empty_like(X)
        none = torch.zeros(m, dtype=torch.int32, device="cuda")
        half = none.clone()
        half[torch.randperm(m, generator=gen)[: m // 2].to("cuda")] = 1
        fns = {"panel_lu": lambda: panel_factor_cuda(P, True)}
        for mc in (8, 16, 32, 64):
            fns[f"micro{mc}_cluster"] = lambda mc=mc: panel_factor_shadow_cuda(P, True, mc)
        fns["shadow32_grid"] = lambda: panel_factor_shadow_cuda(P, True, 32, block=-1)
        fns["basic32_grid"] = lambda: panel_factor_basic_cuda(P, True, 32, block=-1)
        fns["noswap_cluster"] = lambda: panel_factor_noswap_cuda(P, none, True, live=m)
        fns["noswap_grid"] = lambda: panel_factor_noswap_cuda(P, none, True, block=-1)
        fns["noswap_half_cluster"] = lambda: panel_factor_noswap_cuda(P, half, True,
                                                                      live=m - m // 2)
        fns["noswap_half_grid"] = lambda: panel_factor_noswap_cuda(P, half, True, block=-1)
        fns["library"] = lambda: torch.linalg.lu_factor_ex(P)
        t = round_robin(fns, lambda: P.copy_(X))
        print(json.dumps({"timing": [m, w], "card": torch.cuda.get_device_name(0), "ms": t,
                          "plans": {"micro32": micro_plan(m, w, torch.float32, 32),
                                    "noswap": noswap_plan(m, w, torch.float32, live=m),
                                    "noswap_half": noswap_plan(m, w, torch.float32,
                                                               live=m - m // 2)}}),
              flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("check_panel_routes: CUDA is not available", file=sys.stderr)
        return 2
    noswap_only = "noswap" in argv
    build(noswap_only)
    gen = torch.Generator().manual_seed(0)
    bad = 0 if noswap_only else check_micro(gen)
    bad += check_noswap(gen)
    timing(gen)
    print("BAD", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
