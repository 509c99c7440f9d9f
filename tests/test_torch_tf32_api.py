"""The port's full-precision block under PyTorch's current TF32 API.

A caller who set ``torch.backends.cuda.matmul.fp32_precision`` (the
current API) makes PyTorch refuse to read the legacy ``allow_tf32``
flags.  ``utils.config.full_matmul_precision`` then sets and restores the
current attributes instead, so ``lu`` and ``lu_solve`` run, every matmul
and every triangular solve inside (``lu_solve`` substitutes, xTRSM, which
cuBLAS runs under the handle's math mode) sees ``'ieee'`` (and
convolutions no ``'tf32'``), and the caller's setting comes back.  The legacy
API keeps working as before (tests/test_torch_trsm_schur.py).  The
setting is global to a process, so each case runs in a child process.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import json, sys
import torch
from torch.overrides import TorchFunctionMode
import recursivefactorization_jl_tpu_torch as rt

torch.set_num_threads(1)
mm, conv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
mm.fp32_precision = sys.argv[1]
conv.fp32_precision = sys.argv[2]
seen = []

class Watch(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm,
                    torch.linalg.solve_triangular):
            seen.append((mm.fp32_precision, conv.fp32_precision))
        return func(*args, **(kwargs or {}))

g = torch.Generator().manual_seed(0)
n = int(sys.argv[3])
A = torch.randn(n, n, generator=g, dtype=torch.float32)
b = torch.randn(n, generator=g, dtype=torch.float32)
with Watch():
    F = rt.lu(A, device="cpu")
    x = rt.lu_solve(F, b)
r = float((F.L.double() @ F.U.double() - A.double()[F.p.long()]).abs().max())
print(json.dumps(dict(seen=sorted(set(seen)), products=len(seen), info=int(F.info),
                      resid=r, gate=20 * n * 1.1920929e-07 * float(A.abs().max()),
                      solve=float((A.double() @ x.double() - b.double()).abs().max()),
                      after=[mm.fp32_precision, conv.fp32_precision])))
"""


@pytest.mark.parametrize("matmul,conv", [("tf32", "tf32"), ("tf32", "ieee"), ("ieee", "tf32")])
def test_lu_runs_under_the_current_tf32_api_and_restores_it(matmul, conv):
    done = subprocess.run([sys.executable, "-c", PROBE, matmul, conv, "600"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    got = json.loads(done.stdout.strip().splitlines()[-1])
    # matmuls and triangular solves in full float32; convolutions never in TF32 ('none' defers to
    # the legacy flag, which the block has turned off where it set that one)
    assert got["products"] > 0 and {m for m, _ in got["seen"]} == {"ieee"}, got["seen"]
    assert "tf32" not in {c for _, c in got["seen"]}, got["seen"]
    assert got["info"] == 0 and got["resid"] < got["gate"] and got["solve"] < 1e-2
    assert got["after"] == [matmul, conv]
