"""Nothing the runner or the reference imports is JAX or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import json
import subprocess
import sys
import textwrap

from bench_port import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "recursivefactorization_jl_tpu"}
PORT = "recursivefactorization_jl_tpu_torch"


def _loaded_after(code: str) -> set:
    prog = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {str(harness.ROOT)!r})
        {textwrap.indent(textwrap.dedent(code), "        ").strip()}
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
    """)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _loaded_after("""
        import bench_port.run as run
        from bench_port import harness, control
        for p in (harness.BENCH_DIR / "metrics").glob("*.py"):
            harness.load_module(p)
        for p in (harness.BENCH_DIR / "entries").glob("*.py"):
            harness.load_module(p)
        harness.run_cell("batched_f32.replay_n64", 3, 0.1, True, device="cpu",
                         overrides=dict(n=16, batch=8, pool=2))
        harness.run_cell("lu_f32.replay_n4096", 3, 0.1, False, device="cpu",
                         overrides=dict(n=24, pool=2))
        assert run.forbidden_modules() == [], run.forbidden_modules()
    """)
    assert PORT in names  # the port is what runs
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = _loaded_after("""
        import importlib.util, torch
        p = {path!r}
        spec = importlib.util.spec_from_file_location("ref", p)
        ref = importlib.util.module_from_spec(spec); spec.loader.exec_module(ref)
        A = torch.rand(3, 12, 12, dtype=torch.float64) - 0.5
        b = torch.rand(3, 12, dtype=torch.float64) - 0.5
        f, ipiv, info = ref.lu_factor(A)
        x = ref.lu_solve(f, ipiv, b)
        ref.judge(A, b, f, ipiv, info, x, {{"factor": "magma_getrf", "solve": "hpl"}},
                  torch.float64)
    """.format(path=str(harness.BENCH_DIR / "references" / "dense_lu.py")))
    assert not names & (FORBIDDEN | {PORT, "bench_port"})


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    for path in (harness.BENCH_DIR / "references").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in {PORT, "bench_port"}, (path, name)
