"""The compiled entry points of the distributed layer on the CPU:
``tp_lu_factor(_p)`` / ``tp_lu`` / ``tp_lu_solve`` and the sharded batched
pair (utils/graphs.py, a program per rank and group on the card).

(a) The key carries the process group as its name, size and rank.
(b) Their glue reads no device value on the host: the functions run in a
    one-rank gloo group on CPU tensors with the card's routes taken and
    the kernel launchers replaced by stand-ins, while every host read of
    a tensor fails the test (the guards of tests/test_torch_graphs.py).
(c) ``capturing()`` on the CPU captures nothing and changes no result.

A capture needs CUDA tensors and an NCCL group (tests/test_torch_cuda.py,
``chip_smoke.py`` phase 3h); a gloo group asked to capture raises there.
"""

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import recursivefactorization_jl_tpu_torch as rt
from recursivefactorization_jl_tpu_torch.ops import blocked, panel
from recursivefactorization_jl_tpu_torch.utils import graphs
from test_torch_graphs import _install_card_route, _install_guards, _well_conditioned

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one rank in this process (an in-memory store: no
    port), destroyed after the module."""
    if dist.is_initialized():
        pytest.fail("a default process group is already initialised in this process")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("tp",))
    finally:
        dist.destroy_process_group()


def test_the_key_carries_the_group(mesh):
    group = mesh.get_group("tp")
    A = torch.zeros(8, 8)
    key = graphs.program_key("tp_lu_factor", (A,), (group, 4, True, rt.LUConfig()))
    assert key[2][0] == ("group", group.group_name, 1, 0)
    assert key == graphs.program_key("tp_lu_factor", (A,), (group, 4, True, rt.LUConfig()))
    assert key != graphs.program_key("tp_lu_factor", (A,), (group, 8, True, rt.LUConfig()))
    assert graphs._cuda_backend(group) == "gloo"


def _install_offset_stand_ins(mp, calls):
    """The offset kernels' launchers as stand-ins: identity pivots from
    the offset, no host read."""
    def stub(name):
        def launch(P, ofs, pivot, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            H, w = P.shape
            return (torch.arange(ofs, ofs + w, dtype=torch.int32),
                    torch.arange(H, dtype=torch.int32), torch.zeros((), dtype=torch.int32))
        return launch

    mp.setattr(panel, "offset_panel_route", lambda device, config: "kernel")
    mp.setattr(panel, "offset_panel_factor_cuda", stub("offset"))
    mp.setattr(panel, "offset_panel_factor_c64_cuda", stub("offset_c64"))


@pytest.mark.parametrize("dtype,sparse", [
    (torch.float32, False), (torch.float64, True), (torch.complex64, False),
    (torch.bfloat16, False), (torch.int32, False)])
@pytest.mark.parametrize("pivot", [True, False])
def test_tp_glue_reads_no_device_value(mesh, dtype, sparse, pivot):
    """``tp_lu`` (the factor's program and its ``perm`` cut) and
    ``tp_lu_solve`` N / T / H of a vector and of a matrix, n = 70 padded
    to 72 at w = 8 (four stages of shrinking height), with the laswp
    dense and sparse."""
    n, w = 70, 8
    A = (_well_conditioned((n, n), torch.float64, 21) * 10).to(dtype)
    b = _well_conditioned((n,), torch.float64, 22).to(dtype)
    B = _well_conditioned((n, 3), torch.float64, 23).to(dtype)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _install_offset_stand_ins(mp, calls)
        if sparse:
            mp.setattr(blocked, "SPARSE_LASWP_MIN_BYTES", 0)
        _install_guards(mp)
        F = rt.tp_lu(A, mesh, "tp", w, pivot, device="cpu")
        xs = [rt.tp_lu_solve(F, rhs, mesh, "tp", w, trans=t, device="cpu")
              for t in ("N", "T", "H") for rhs in (b, B)]
    assert calls == {("offset_c64" if dtype.is_complex else "offset"): 9}
    work = torch.float64 if dtype == torch.int32 else dtype
    assert F.factors.shape == (n, n) and F.factors.dtype == work and F.p.shape == (n,)
    assert [x.shape for x in xs] == [(n,), (n, 3)] * 3


@pytest.mark.parametrize("n,trans", [(16, 0), (64, 0), (16, 1)])
def test_sharded_glue_reads_no_device_value(mesh, n, trans):
    """``sharded_batched_lu_factor`` and ``_solve`` at one gloo rank: the
    nested batched functions on the kernels' routes and the
    ``all_reduce`` gathers.  ``trans`` goes to the unsharded solve only
    (the sharded one has none): its library route's glue."""
    A = _well_conditioned((6, n, n), torch.float32, 24)
    b = _well_conditioned((6, n), torch.float32, 25)
    calls = {}
    with pytest.MonkeyPatch.context() as mp:
        _install_card_route(mp, calls)
        _install_guards(mp)
        f, ipiv, info = rt.sharded_batched_lu_factor(A, mesh, "tp", device="cpu")
        x = rt.sharded_batched_lu_solve(f, ipiv, b, mesh, "tp", device="cpu")
        y = rt.batched_lu_solve(f, ipiv, b, trans=trans, device="cpu")
    assert f.shape == A.shape and ipiv.shape == (6, n) and info.shape == (6,)
    assert x.shape == y.shape == (6, n)
    assert calls == {"batched_lu": 1, "batched_solve": 1 + (trans == 0)}


def test_the_tp_guard_catches_a_host_read_in_the_loop(mesh):
    """A host read of ``info`` inside the panel loop (what a capture cannot
    record) is caught by the guards."""
    from recursivefactorization_jl_tpu_torch.parallel import blockcyclic

    real = blockcyclic._offset_info

    def reading(info, linfo, s):
        int(linfo)
        return real(info, linfo, s)

    A = _well_conditioned((32, 32), torch.float32, 26)
    with pytest.MonkeyPatch.context() as mp:
        _install_offset_stand_ins(mp, {})
        mp.setattr(blockcyclic, "_offset_info", reading)
        _install_guards(mp)
        with pytest.raises(AssertionError, match="__int__"):
            rt.tp_lu(A, mesh, "tp", 8, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_capturing_on_the_cpu_captures_nothing_for_the_distributed_functions(mesh, dtype):
    n, w = 40, 8
    A = _well_conditioned((n, n), dtype, 27)
    b = _well_conditioned((n, 2), dtype, 28)
    Ab = _well_conditioned((4, 12, 12), torch.float64, 29)
    bb = _well_conditioned((4, 12), torch.float64, 30)

    def run():
        F = rt.tp_lu(A, mesh, "tp", w, device="cpu")
        x = rt.tp_lu_solve(F, b, mesh, "tp", w, trans="T", device="cpu")
        f, ipiv, info = rt.sharded_batched_lu_factor(Ab, mesh, "tp", device="cpu")
        y = rt.sharded_batched_lu_solve(f, ipiv, bb, mesh, "tp", device="cpu")
        return F.factors, F.ipiv, F.p, F.info, x, f, ipiv, info, y

    before = run()
    with graphs.capturing():
        during = run()
    assert graphs.programs() == {}
    for x, y in zip(before, during):
        assert torch.equal(x, y)
