"""``utils/profiling.py`` and ``utils/warmup.py`` of the port on the CPU:
the twin of tests/test_config_warmup.py's warmup test and of the JAX
package's profiling helpers (their names and return shapes).  On the
card the same functions time with CUDA events and build the kernels; the
CPU runs here check the control flow and what the functions return, not
a time."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu.utils import profiling as jax_profiling
from recursivefactorization_jl_tpu_torch.ops import _kernels
from recursivefactorization_jl_tpu_torch.utils import profiling, warmup

torch.set_num_threads(1)


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir), device="cpu") as d:
        rt.lu(torch.randn(48, 48, dtype=torch.float64), device="cpu")
    assert d == str(logdir)
    with open(logdir / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_timed_returns_best_seconds_and_the_last_result():
    A = torch.tensor(np.random.default_rng(1).standard_normal((32, 32)))
    best, F = profiling.timed(lambda M: rt.lu(M, device="cpu"), A, reps=2)
    assert isinstance(best, float) and best > 0
    assert isinstance(F, rt.LU) and int(F.info) == 0


def test_marginal_time_stats_returns_the_jax_packages_keys():
    """Exactly the keys the JAX package's ``marginal_time_stats`` returns,
    with the port's counts; ``marginal_time`` is its median."""
    want = jax_profiling.marginal_time_stats(lambda a: a @ a, jnp.eye(4), k1=1, k2=2, reps=2)
    x = torch.randn(64, 64)
    got = profiling.marginal_time_stats(lambda a: a @ a, x, k1=1, k2=4, reps=3)
    assert set(got) == set(want)
    assert (got["reps"], got["k1"], got["k2"]) == (3, 1, 4)
    assert got["min_s"] <= got["time_s"] <= got["max_s"]
    assert 0 <= got["negative_reps"] <= 3
    assert isinstance(profiling.marginal_time(lambda a: a @ a, x, 1, 3, 2), float)
    with pytest.raises(ValueError):
        profiling.marginal_time_stats(lambda a: a, x, k1=3, k2=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64, torch.bfloat16, torch.int32])
def test_warmup_runs(dtype):
    """One factor and solve per shape and dtype on the CPU (no build
    there), square and rectangular, through every route the dtype takes."""
    warmup.warmup(((32, 32), (40, 24)), (dtype,), device="cpu")
    warmup.warmup(((16, 16),), (dtype,), pivot=False, solve=False,
                  config=rt.LUConfig(panel_width=8, small_threshold=8), device="cpu")


def test_warmup_without_a_card_raises():
    """``device=None`` means the card, as at every entry point."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        warmup.warmup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with profiling.trace():
            pass


def test_enable_persistent_cache_moves_the_build_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(_kernels, "BUILD_DIR", _kernels.BUILD_DIR)
    target = tmp_path / "kernels"
    warmup.enable_persistent_cache(str(target))
    assert target.is_dir() and _kernels.BUILD_DIR == target
    assert {_kernels.library_path(n).parent for n in _kernels.SOURCES} == {target}
    # the default is the installed package's cache under the home directory
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    warmup.enable_persistent_cache()
    assert _kernels.BUILD_DIR == tmp_path / "home" / ".cache" / \
        "recursivefactorization_jl_tpu_torch" / "kernels"
    assert os.path.isdir(_kernels.BUILD_DIR)


def test_warmup_builds_only_the_packages_own_kernels(tmp_path, monkeypatch):
    """``build()``'s default (what ``warmup`` builds) is the package's six
    sources; the trace build of csrc/batched_lu.cu is built only when
    named (``load("batched_lu_trace")`` names it), with its own flag."""
    assert "batched_lu_trace" not in _kernels.SOURCES
    assert _kernels.build.__defaults__[0] == tuple(_kernels.SOURCES)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", lambda: "nvcc")
    commands = []

    class Done:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            return "", None

    monkeypatch.setattr(_kernels.subprocess, "Popen", Done)
    built = _kernels.build(["batched_lu_trace"])
    (cmd,) = commands
    assert "-DRF_BATCHED_TRACE" in cmd and cmd[-1] == str(_kernels.SOURCES["batched_lu"])
    assert built["batched_lu_trace"].is_file()
    assert _kernels.library_path("batched_lu_trace") != _kernels.library_path("batched_lu")
    commands.clear()
    _kernels.build()
    assert len(commands) == len(_kernels.SOURCES)
    assert not any("-DRF_BATCHED_TRACE" in c for c in commands)
