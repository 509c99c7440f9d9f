"""The compiled entry points (utils/graphs.py) on the CPU.

(a) The port's program key matches the JAX package's ``jax.jit`` reuse:
    one seeded sequence of factor and solve calls makes as many programs
    in the JAX package's jitted ``_lu_factor`` / ``_lu_solve_impl`` as it
    makes distinct keys in the port.
(b) The card route's Python glue reads no device value on the host, so one
    capture serves every input of a key: the entry points run on CPU
    tensors with the card's routes taken and the kernel launchers replaced
    by stand-ins, while every host read of a tensor fails the test.
(c) ``warmup`` on the CPU captures nothing and changes no result.
(d) The same for ``lu_inplace`` / ``donate=True`` and the RBT solver:
    their keys against the JAX package's ``_lu_factor_donated``,
    ``_workspace_arrays``, ``_butterfly_solve_impl`` and
    ``_materialize_uv_jit``, their glue under the guards (a program's
    constants are made with the guards lifted, as outside its graph), and
    ``capturing()`` on the CPU.  tests/test_torch_graphs_dist.py does the
    same for the distributed functions.

The captures and replays themselves run only on the card
(tests/test_torch_cuda.py, ``chip_smoke.py`` phase 3h).
"""

import numpy as np
import pytest
import torch

import recursivefactorization_jl_tpu as rf
from recursivefactorization_jl_tpu.models import butterfly as jax_butterfly
from recursivefactorization_jl_tpu.models.lu import _lu_factor as jax_lu_factor
from recursivefactorization_jl_tpu.models.lu import _lu_factor_donated as jax_lu_factor_donated
from recursivefactorization_jl_tpu.models.solve import _lu_solve_impl as jax_lu_solve_impl

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops import batched_kernel as bk
from recursivefactorization_jl_tpu_torch.ops import blocked, panel
from recursivefactorization_jl_tpu_torch.utils import graphs, warmup

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (a) the key against jax.jit's cache
# ---------------------------------------------------------------------------

_SHAPES = [(6, 6), (9, 6), (6, 9), (7, 7)]
_CONFIGS = [{}, {}, {"trsm_block": 64}, {"panel_width": 256}]  # two equal, two not
_TRANS = [0, "T", 2, "N", 1, "H"]


def _sequence(seed=16, calls=30):
    """Seeded factor calls (shape, dtype, pivot, config) and, on square
    shapes, a solve of each (b shape, trans)."""
    rng = np.random.default_rng(seed)
    seq = []
    for _ in range(calls):
        m, n = _SHAPES[rng.integers(len(_SHAPES))]
        dtype = (np.float32, np.float64)[rng.integers(2)]
        pivot = bool(rng.integers(2))
        cfg = _CONFIGS[rng.integers(len(_CONFIGS))]
        A = (rng.standard_normal((m, n)) + 4 * np.eye(m, n)).astype(dtype)
        solve = None
        if m == n:
            bshape = ((n,), (n, 2))[rng.integers(2)]
            solve = (rng.standard_normal(bshape).astype(dtype), _TRANS[rng.integers(len(_TRANS))])
        seq.append((A, pivot, cfg, solve))
    return seq


def _spy_keys(mp, keys):
    """Every program key the entry points compute goes into ``keys``."""
    real_key = graphs.program_key

    def spy(kind, tensors, statics):
        key = real_key(kind, tensors, statics)
        keys.add(key)
        return key

    mp.setattr(graphs, "program_key", spy)


def test_program_keys_match_the_jit_cache_of_the_jax_package(monkeypatch):
    seq = _sequence()
    jax_lu_factor.clear_cache()
    jax_lu_solve_impl.clear_cache()
    for A, pivot, cfg, solve in seq:
        F = rf.lu(A, pivot, check=False, config=rf.LUConfig(**cfg))
        if solve is not None:
            rf.lu_solve(F, solve[0], solve[1])
    jax_programs = (jax_lu_factor._cache_size(), jax_lu_solve_impl._cache_size())

    keys = set()
    _spy_keys(monkeypatch, keys)
    for A, pivot, cfg, solve in seq:
        F = rt.lu(A, pivot, check=False, config=rt.LUConfig(**cfg), device="cpu")
        if solve is not None:
            rt.lu_solve(F, solve[0], solve[1])
    port_programs = tuple(sum(k[0] == kind for k in keys) for kind in ("lu_factor", "lu_solve"))
    assert port_programs == jax_programs
    # the sequence repeats keys and varies every part of them
    assert 1 < port_programs[0] < len(seq) and port_programs[1] > 1


def test_equal_configs_share_a_key_and_unequal_ones_do_not():
    A = torch.zeros(4, 4)
    key = lambda cfg: graphs.program_key("lu_factor", (A,), (True, cfg))  # noqa: E731
    assert key(rt.LUConfig()) == key(rt.LUConfig())
    assert key(rt.LUConfig()) != key(rt.LUConfig(trsm_block=64))
    assert graphs.program_key("lu_factor", (A,), (True, rt.LUConfig())) != graphs.program_key(
        "lu_factor", (A.double(),), (True, rt.LUConfig()))


# ---------------------------------------------------------------------------
# (b) no host read of a device value on the card route's glue
# ---------------------------------------------------------------------------

class HostRead(AssertionError):
    pass


def _guard(name):
    def guarded(*args, **kwargs):
        raise HostRead(f"Tensor.{name} on the card route")
    return guarded


def _guard_to(real):
    def to(self, *args, **kwargs):
        dev = kwargs.get("device")
        for a in args:
            if isinstance(a, (str, torch.device)):
                dev = a
        if dev is not None and torch.device(dev).type == "cpu":
            raise HostRead("Tensor.to('cpu') on the card route")
        return real(self, *args, **kwargs)
    return to


def _install_card_route(mp, calls):
    """The card's routes on CPU tensors, each kernel launcher a stand-in
    that returns outputs of the right shapes and dtypes (counted in
    ``calls``) and reads nothing on the host."""
    real_route = panel.panel_route

    def route(m, w, dtype, config, device="cuda"):
        return real_route(m, w, dtype, config, "cuda")

    def panel_stub(name):
        def launch(P, pivot, *args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            m, w = P.shape
            return (torch.arange(min(m, w), dtype=torch.int32),
                    torch.arange(m, dtype=torch.int32), torch.zeros((), dtype=torch.int32))
        return launch

    def noswap_stub(P, used0, pivot, live=None):
        calls["noswap"] = calls.get("noswap", 0) + 1
        rows = torch.argsort(used0, stable=True)[: min(P.shape)]
        used = used0.to(torch.int32).clone()
        used.index_fill_(0, rows, 1)
        return rows.to(torch.int32), used, torch.zeros((), dtype=torch.int32)

    def batched_stub(A, pivot=True, with_perm=True):
        calls["batched_lu"] = calls.get("batched_lu", 0) + 1
        B, m, n = A.shape
        ipiv = torch.arange(min(m, n), dtype=torch.int32).repeat(B, 1)
        perm = torch.arange(m, dtype=torch.int32).repeat(B, 1) if with_perm else None
        return A.clone(), ipiv, perm, torch.zeros(B, dtype=torch.int32)

    def solve_stub(factors, b, perm=None, ipiv=None):
        calls["batched_solve"] = calls.get("batched_solve", 0) + 1
        return b.to(factors.dtype).clone()

    mp.setattr(panel, "panel_route", route)
    for name in ("panel_factor_cuda", "panel_factor_c64_cuda", "panel_factor_shadow_cuda",
                 "panel_factor_basic_cuda"):
        mp.setattr(panel, name, panel_stub(name))
    mp.setattr(blocked, "panel_factor_noswap", noswap_stub)
    mp.setattr(bk, "batched_lu", batched_stub)
    mp.setattr(bk, "batched_solve", solve_stub)


def _guard_setitem(real):
    def setitem(self, index, value):
        idx = index if isinstance(index, tuple) else (index,)
        if isinstance(value, (bool, int, float, complex)) and any(
                isinstance(i, torch.Tensor) for i in idx):
            # index_put_ takes the number as a CPU tensor: a host copy on the card
            raise HostRead("a Python number stored through a tensor index on the card route")
        return real(self, index, value)
    return setitem


def _install_guards(mp):
    for name in ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy",
                 "cpu"):
        mp.setattr(torch.Tensor, name, _guard(name))
    mp.setattr(torch.Tensor, "to", _guard_to(torch.Tensor.to))
    mp.setattr(torch.Tensor, "__setitem__", _guard_setitem(torch.Tensor.__setitem__))


def _well_conditioned(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(*shape, generator=g, dtype=torch.float64)
    if len(shape) > 1:
        A = A + 8 * torch.eye(shape[-2], shape[-1], dtype=torch.float64)
    return A.to(dtype)


_SMALL = dict(small_threshold=8, panel_width=16)
# (name, shape, dtype, config fields, pivot, kernel launchers expected);
# "_sparse" cases take the blocked schedule's sparse laswp
_FACTOR_CASES = [
    ("whole", (12, 12), torch.float32, {}, True, {"panel_factor_cuda"}),
    ("whole_nopivot", (12, 12), torch.float64, {}, False, {"panel_factor_cuda"}),
    ("blocked", (40, 40), torch.float32, _SMALL, True, {"panel_factor_cuda"}),
    ("blocked_sparse", (40, 40), torch.float32, _SMALL, True, {"panel_factor_cuda"}),
    ("blocked_tall", (56, 40), torch.float64, _SMALL, True, {"panel_factor_cuda"}),
    ("blocked_tall_sparse", (56, 40), torch.float64, _SMALL, True, {"panel_factor_cuda"}),
    ("blocked_fat", (24, 40), torch.float32, _SMALL, True, {"panel_factor_cuda"}),
    ("blocked_tail", (40, 40), torch.float32, {**_SMALL, "tail_threshold": 16}, True,
     {"panel_factor_cuda"}),
    ("blocked_tail_sparse", (40, 40), torch.float32, {**_SMALL, "tail_threshold": 16}, True,
     {"panel_factor_cuda"}),
    ("blocked_schur_bf16x3", (40, 40), torch.float32, {**_SMALL, "schur_precision": "bf16x3"},
     True, {"panel_factor_cuda"}),
    ("physical", (40, 40), torch.float32, {**_SMALL, "schedule": "physical"}, True, {"noswap"}),
    ("physical_tall", (56, 40), torch.float64, {**_SMALL, "schedule": "physical"}, True,
     {"noswap"}),
    ("bf16x3", (40, 40), torch.float32, {**_SMALL, "panel_boundary_precision": "bf16x3"},
     True, {"panel_factor_cuda"}),
    ("shadow", (40, 40), torch.float32, {**_SMALL, "panel_variant": "shadow"}, True,
     {"panel_factor_shadow_cuda"}),
    ("basic", (40, 40), torch.float64, {**_SMALL, "panel_variant": "basic"}, True,
     {"panel_factor_basic_cuda"}),
    ("complex", (40, 40), torch.complex64, _SMALL, True, {"panel_factor_c64_cuda"}),
    ("promote", (40, 40), torch.bfloat16, _SMALL, True, {"panel_factor_cuda"}),
    ("generic", (40, 40), torch.int32, _SMALL, True, {"panel_factor_cuda"}),
    # the delegated route: lu_factor_ex, the perm folded from ipiv on the device
    ("xla", (40, 40), torch.float32, {"xla_threshold": 64}, True, set()),
]


@pytest.mark.parametrize("name,shape,dtype,fields,pivot,launchers", _FACTOR_CASES,
                         ids=[c[0] for c in _FACTOR_CASES])
def test_factor_glue_reads_no_device_value(monkeypatch, name, shape, dtype, fields, pivot,
                                           launchers):
    """``lu_factor_p`` (``_dispatch_factor`` on every route the card
    takes), with the blocked schedule's laswp dense and sparse."""
    A = (_well_conditioned(shape, torch.float64, 1) * 10).to(dtype)
    cfg = rt.LUConfig(**fields)
    calls = {}
    with monkeypatch.context() as mp:
        _install_card_route(mp, calls)
        if name.endswith("_sparse"):
            mp.setattr(blocked, "SPARSE_LASWP_MIN_BYTES", 0)
        _install_guards(mp)
        factors, ipiv, perm, info = rt.lu_factor_p(A, pivot, config=cfg, device="cpu")
    assert set(calls) == launchers
    assert factors.shape == shape and perm.shape == (shape[0],) and info.shape == ()


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128, torch.float16])
@pytest.mark.parametrize("pivoted", [True, False])
@pytest.mark.parametrize("trans", [0, 1, 2])
def test_solve_glue_reads_no_device_value(monkeypatch, trans, pivoted, dtype):
    """``lu_solve`` (``_lu_solve_impl``, trans 0/1/2, blocked sweeps at
    n = 300) and ``lu_solve_refined``."""
    n = 300
    A = _well_conditioned((n, n), dtype, 2)
    F = rt.LU(A.clone(), torch.arange(n, dtype=torch.int32), torch.zeros((), dtype=torch.int32),
              pivoted=pivoted, perm=torch.randperm(n, generator=torch.Generator().manual_seed(3))
              .to(torch.int32))
    b = _well_conditioned((n, 2), dtype, 4)
    with monkeypatch.context() as mp:
        _install_card_route(mp, {})
        _install_guards(mp)
        x = rt.lu_solve(F, b, trans)
        xr = rt.lu_solve_refined(F, A, b[:, 0], iters=1, trans=trans)
    assert x.shape == (n, 2) and xr.shape == (n,) and x.dtype == xr.dtype == dtype


@pytest.mark.parametrize("fields", [{}, _SMALL], ids=["whole", "blocked"])
def test_fused_solve_glue_reads_no_device_value(monkeypatch, fields):
    A = _well_conditioned((40, 40), torch.float32, 5)
    b = _well_conditioned((40,), torch.float32, 6)
    calls = {}
    with monkeypatch.context() as mp:
        _install_card_route(mp, calls)
        _install_guards(mp)
        x = rt.solve(A, b, check=False, config=rt.LUConfig(**fields), device="cpu")
    assert x.shape == (40,) and calls == {"panel_factor_cuda": 1 if not fields else 3}


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("n", [16, 64])
def test_batched_glue_reads_no_device_value(monkeypatch, n, trans):
    """The four batched functions (the kernels' routes, and the library
    route of a transposed solve)."""
    A = _well_conditioned((7, n, n), torch.float32, 7)
    b = _well_conditioned((7, n), torch.float32, 8)
    calls = {}
    with monkeypatch.context() as mp:
        _install_card_route(mp, calls)
        _install_guards(mp)
        f, perm, info = rt.batched_lu_factor_perm(A, device="cpu")
        x1 = rt.batched_lu_solve_perm(f, perm, b, trans=trans, device="cpu")
        f, ipiv, info = rt.batched_lu_factor(A, device="cpu")
        x2 = rt.batched_lu_solve(f, ipiv, b, trans=trans, device="cpu")
    assert x1.shape == x2.shape == (7, n)
    assert calls == {"batched_lu": 2, **({"batched_solve": 2} if trans == 0 else {})}


def test_the_guards_catch_a_host_read(monkeypatch):
    """The guards of (b) see the reads the glue must not make."""
    t = torch.arange(4)
    with monkeypatch.context() as mp:
        _install_guards(mp)
        for read in (lambda: int(t[0]), lambda: bool(t[0]), lambda: t.tolist(),
                     lambda: t.to("cpu"), lambda: t.cpu(), lambda: rt.lu(
                         torch.eye(3), device="cpu")):
            with pytest.raises(HostRead):
                read()


# ---------------------------------------------------------------------------
# (c) warmup on the CPU, and the replay's outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
def test_warmup_on_the_cpu_captures_nothing(dtype):
    A = _well_conditioned((24, 24), dtype, 9)
    b = _well_conditioned((24,), dtype, 10)
    before = rt.lu(A, device="cpu")
    x_before = rt.lu_solve(before, b)
    warmup.warmup(((24, 24), (30, 20)), (dtype,), device="cpu")
    assert graphs.programs() == {}
    after = rt.lu(A, device="cpu")
    assert torch.equal(after.factors, before.factors)
    assert torch.equal(after.p, before.p) and torch.equal(after.ipiv, before.ipiv)
    assert torch.equal(rt.lu_solve(after, b), x_before)
    warmup.clear_caches()
    assert graphs.programs() == {}


def test_capture_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="only CUDA tensors"):
        graphs.capture("lu_factor", lambda A: A, (torch.eye(3),), ())


class _StandInGraph:
    """A graph whose replay reruns the program on its static inputs."""

    def __init__(self, program, fn):
        self.program, self.fn = program, fn

    def replay(self):
        out = self.fn(*self.program.inputs)
        for static, o in zip(self.program.outputs, out):
            static.copy_(o)


class _StandInStream:
    """Records the order of a replay's waits and event records."""

    def __init__(self, log):
        self.log = log

    def wait_event(self, event):
        self.log.append(("wait", event))


class _StandInEvent:
    def __init__(self, log):
        self.log = log

    def record(self, stream):
        self.log.append(("record", self))


def test_a_replay_copies_in_and_returns_fresh_outputs(monkeypatch):
    """One copy into the static inputs, one replay, fresh copies out, after
    the previous replay's copies out: a later call does not overwrite an
    earlier call's results."""
    import threading

    log = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StandInStream(log))
    fn = lambda A: (A * 2, A.sum())  # noqa: E731
    program = object.__new__(graphs._Program)
    program.inputs = (torch.zeros(3),)
    program.outputs = tuple(o.clone() for o in fn(program.inputs[0]))
    program.single, program.replays, program.device = False, 0, torch.device("cpu")
    program._lock, program._done = threading.Lock(), _StandInEvent(log)
    program.graph = _StandInGraph(program, fn)
    x1, s1 = program(torch.tensor([1.0, 2.0, 3.0]))
    x2, s2 = program(torch.tensor([4.0, 5.0, 6.0]))
    assert torch.equal(x1, torch.tensor([2.0, 4.0, 6.0])) and float(s1) == 6.0
    assert torch.equal(x2, torch.tensor([8.0, 10.0, 12.0])) and float(s2) == 15.0
    assert program.replays == 2 and x2.data_ptr() != program.outputs[0].data_ptr()
    assert [k for k, _ in log] == ["wait", "record", "wait", "record"]
    assert all(e is program._done for _, e in log)


# ---------------------------------------------------------------------------
# the donated factor and the RBT solver: keys, glue, CPU captures
# ---------------------------------------------------------------------------

_GUARDED = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist", "numpy", "cpu",
            "to", "__setitem__")
_REAL = {name: getattr(torch.Tensor, name) for name in _GUARDED}


class _HostReadsAllowed:
    """Within the block the guards of (b) are lifted (the tensors a
    program makes once, outside its graph, as its constants)."""

    def __enter__(self):
        self.guarded = {name: getattr(torch.Tensor, name) for name in _GUARDED}
        for name, fn in _REAL.items():
            setattr(torch.Tensor, name, fn)

    def __exit__(self, *exc):
        for name, fn in self.guarded.items():
            setattr(torch.Tensor, name, fn)


def _constants_outside_the_guards(mp):
    """``graphs.call`` with a program's constants made where host reads
    are allowed: only the program's own code (what the graph records)
    stays guarded."""
    real_call = graphs.call

    def call(kind, fn, tensors, statics, *, constants=None, donate=False):
        if constants is not None:
            with _HostReadsAllowed():
                made = constants()
            constants = lambda: made  # noqa: E731
        return real_call(kind, fn, tensors, statics, constants=constants, donate=donate)

    mp.setattr(graphs, "call", call)


def test_donated_keys_match_the_jit_cache_of_the_jax_package(monkeypatch):
    """A seeded run of ``lu_inplace`` calls makes as many distinct
    ``lu_factor_donated`` keys as the JAX package's ``_lu_factor_donated``
    compiles (its ``lu_inplace`` donates when ``check=False``)."""
    seq = [(A, pivot, cfg) for A, pivot, cfg, _ in _sequence(seed=17, calls=24)]
    jax_lu_factor_donated.clear_cache()
    for A, pivot, cfg in seq:
        rf.lu_inplace(np.array(A), pivot, check=False, config=rf.LUConfig(**cfg))
    jax_programs = jax_lu_factor_donated._cache_size()

    keys = set()
    _spy_keys(monkeypatch, keys)
    for A, pivot, cfg in seq:
        T = torch.from_numpy(A.copy())
        F = rt.lu_inplace(T, pivot, check=False, config=rt.LUConfig(**cfg), device="cpu")
        assert F.factors is T
    port_programs = sum(k[0] == "lu_factor_donated" for k in keys)
    assert port_programs == jax_programs
    assert 1 < port_programs < len(seq)


def test_rbt_keys_match_the_jit_caches_of_the_jax_package(monkeypatch):
    """n = 9..20 (padded to 12 / 16 / 20), two seeds, refine 0 / 1: the
    port's ``butterfly_workspace`` / ``butterfly_solve`` / ``UV`` keys
    against ``_workspace_arrays`` / ``_butterfly_solve_impl`` /
    ``_materialize_uv_jit``."""
    rng = np.random.default_rng(18)
    calls = []
    for n in range(9, 21):
        for seed in (888, 5):
            refine = int(rng.integers(2)) if n % 3 else n % 2
            A = rng.standard_normal((n, n)) + n * np.eye(n)
            b = rng.standard_normal(n) if n % 2 else rng.standard_normal((n, 2))
            calls.append((A, b, seed, refine))
    jitted = (jax_butterfly._workspace_arrays, jax_butterfly._butterfly_solve_impl,
              jax_butterfly._materialize_uv_jit)
    for f in jitted:
        f.clear_cache()
    for A, b, seed, refine in calls:
        ws = rf.butterfly_workspace(A, b, seed)
        rf.butterfly_solve(ws, refine=refine)
        ws.UV()
    jax_programs = tuple(f._cache_size() for f in jitted)

    keys = set()
    _spy_keys(monkeypatch, keys)
    for A, b, seed, refine in calls:
        ws = rt.butterfly_workspace(A, b, seed, device="cpu")
        x = rt.butterfly_solve(ws, refine=refine)
        assert x.shape == b.shape
        ws.UV()
    port_programs = tuple(sum(k[0] == kind for k in keys)
                          for kind in ("butterfly_workspace", "butterfly_solve", "materialize_uv"))
    assert port_programs == jax_programs
    # one workspace per (n, b's shape, seed), one solve per padded shape and
    # refine, one UV per padded size
    assert port_programs[0] == len(calls) and port_programs[2] == 3


_DONATED_CASES = [c for c in _FACTOR_CASES if c[0] != "generic"]


@pytest.mark.parametrize("name,shape,dtype,fields,pivot,launchers", _DONATED_CASES,
                         ids=[c[0] for c in _DONATED_CASES])
def test_donated_factor_glue_reads_no_device_value(monkeypatch, name, shape, dtype, fields,
                                                   pivot, launchers):
    """``lu_inplace`` / ``lu_factor(donate=True)`` (the ``lu_factor_donated``
    program) on every route the card takes; ``factors`` stays ``A``."""
    cfg = rt.LUConfig(**fields)
    A, A2 = ((_well_conditioned(shape, torch.float64, s) * 10).to(dtype) for s in (1, 2))
    calls = {}
    with monkeypatch.context() as mp:
        _install_card_route(mp, calls)
        if name.endswith("_sparse"):
            mp.setattr(blocked, "SPARSE_LASWP_MIN_BYTES", 0)
        _install_guards(mp)
        F = rt.lu_inplace(A, pivot, check=False, config=cfg, device="cpu")
        factors, ipiv, perm, info = rt.lu_factor_p(A2, pivot, config=cfg, donate=True,
                                                   device="cpu")
    assert set(calls) == launchers
    assert F.factors is A and factors is A2
    assert perm.shape == (shape[0],) and info.shape == ()


@pytest.mark.parametrize("n,dtype", [(38, torch.float32), (40, torch.float64)])
@pytest.mark.parametrize("refine", [0, 2])
@pytest.mark.parametrize("nrhs", [None, 3])
def test_rbt_glue_reads_no_device_value(monkeypatch, n, dtype, refine, nrhs):
    """``butterfly_workspace`` (the butterfly values made outside the
    guards, as a program makes its constant outside its graph),
    ``butterfly_solve`` with its nested pivot-free ``lu_factor`` on the
    blocked route, and ``BWorkspace.UV``."""
    A = _well_conditioned((n, n), dtype, 11)
    b = _well_conditioned((n,) if nrhs is None else (n, nrhs), dtype, 12)
    cfg = rt.LUConfig(**_SMALL)
    calls = {}
    with monkeypatch.context() as mp:
        _install_card_route(mp, calls)
        _constants_outside_the_guards(mp)
        _install_guards(mp)
        ws = rt.butterfly_workspace(A, b, device="cpu")
        x, info = rt.butterfly_solve(ws, config=cfg, return_info=True, refine=refine)
        U, V = ws.UV()
    assert calls == {"panel_factor_cuda": 3}
    assert ws.A.shape == (40, 40) and x.shape == b.shape and info.shape == ()
    assert U.shape == V.shape == (40, 40)


def test_the_rbt_guard_sees_values_made_inside_the_program(monkeypatch):
    """The butterfly values' copy from the CPU generator is a host
    operation: made inside the guarded program, it is caught."""
    with monkeypatch.context() as mp:
        _install_guards(mp)
        with pytest.raises(HostRead):
            rt.generate_butterfly_values(8, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
def test_capturing_on_the_cpu_captures_nothing_for_the_new_entry_points(dtype):
    """``capturing()`` around ``lu_inplace``, the RBT calls and ``UV`` on
    CPU tensors makes no program and changes no result."""
    n = 22
    A = _well_conditioned((n, n), dtype, 13)
    b = _well_conditioned((n, 2), dtype, 14)

    def run():
        F = rt.lu_inplace(A.clone(), device="cpu")
        ws = rt.butterfly_workspace(A, b, seed=3, device="cpu")
        x = rt.butterfly_solve(ws, refine=1)
        return (F.factors, F.ipiv, F.p, F.info, ws.A, ws.b, ws.uv, x) + tuple(ws.UV())

    before = run()
    with graphs.capturing():
        during = run()
    warmup.warmup(((n, n),), (dtype,), device="cpu")
    assert graphs.programs() == {}
    for x, y, z in zip(before, during, run()):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_the_guards_catch_a_number_stored_through_a_tensor_index(monkeypatch):
    """``A[idx, idx] = 1`` copies the number in from the host on the card
    (a capture refuses it); a fill through a view does not."""
    A = torch.zeros(4, 4)
    idx = torch.arange(2)
    with monkeypatch.context() as mp:
        _install_guards(mp)
        with pytest.raises(HostRead):
            A[idx, idx] = 1
        A.diagonal()[2:].fill_(1)
        A[1:, :2] = A[:3, 2:]
    assert A.diagonal().tolist() == [0, 0, 1, 1]


def test_a_donated_replay_writes_the_callers_tensor(monkeypatch):
    """A donated program's replay copies output 0 into the caller's tensor
    0 and returns that tensor itself; the other outputs are fresh copies."""
    import threading

    log = []
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StandInStream(log))

    def fn(A):  # in place, as _dispatch_factor factors its input
        A.mul_(2)
        return A, A.sum()

    program = object.__new__(graphs._Program)
    program.inputs = (torch.zeros(3),)
    program.outputs = fn(program.inputs[0])
    program.single, program.replays, program.device = False, 0, torch.device("cpu")
    program.donate = True
    program._lock, program._done = threading.Lock(), _StandInEvent(log)
    program.graph = _StandInGraph(program, lambda A: fn(A.clone()))
    T = torch.tensor([1.0, 2.0, 3.0])
    factors, total = program(T)
    assert factors is T and torch.equal(T, torch.tensor([2.0, 4.0, 6.0]))
    assert float(total) == 12.0 and total.data_ptr() != program.outputs[1].data_ptr()
    assert [k for k, _ in log] == ["wait", "record"]
