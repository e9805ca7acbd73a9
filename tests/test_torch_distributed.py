"""Port parity, block-partitioned closures on a logical mesh
(``repro_torch.core.distributed``): the closure part of
``tests/test_distributed.py`` on logical 1 x 1, 1 x 2, 2 x 2 and
``(pod, data, model)`` grids, both schedules, with and without the kernel
wrapper (its plain version on the CPU), against the dense closure, the
reference's rounds (capped ``rounds=`` included) and — through a
subprocess on four host devices — the reference's padded W* byte for
byte.  Tolerance 0: closures of integer overlaps are exact in float32."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro.core.distributed as ref_dist
from repro.compat import make_mesh as ref_make_mesh
import repro_torch.core.distributed as dist
from repro_torch.core.hypergraph import random_hypergraph
from repro_torch.core.mesh import LogicalMesh, make_mesh
from repro_torch.core.semiring import distinct_thresholds, mr_matrix
from repro_torch.kernels import maxmin_matmul as mm

from util_subproc import SRC

GRIDS = [(1, 1), (1, 2), (2, 2)]
GRID_IDS = ["1x1", "1x2", "2x2"]


def _mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, device="cpu")


def _line_graph(seed=3):
    h = random_hypergraph(30, 26, seed=seed)
    return h, h.line_graph(np.int32).astype(np.float32)


def test_logical_mesh_is_the_reference_mesh_shape():
    mesh = _mesh((2, 3))
    assert mesh.axis_names == ("data", "model")
    assert dict(mesh.shape) == {"data": 2, "model": 3}
    assert mesh.devices.shape == (2, 3) and mesh.devices.size == 6
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh == _mesh((2, 3)) and hash(mesh) == hash(_mesh((2, 3)))
    assert mesh != _mesh((3, 2)) and mesh != _mesh((2, 3), ("a", "b"))
    assert isinstance(mesh, LogicalMesh)
    one = dist.default_line_graph_mesh(device="cpu")
    assert dict(one.shape) == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        _mesh((2, 2), ("data",))
    with pytest.raises(ValueError):
        _mesh((0, 2))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 3), (4, 1)])
def test_pad_for_mesh_equals_the_reference(shape):
    ref_mesh = types.SimpleNamespace(
        shape={"data": shape[0], "model": shape[1]})
    mesh = _mesh(shape)
    for w in (np.arange(49, dtype=np.float32).reshape(7, 7),
              np.ones((3, 5, 5), np.float32), np.zeros((6, 6), np.int32)):
        want = ref_dist.pad_for_mesh(w, ref_mesh)
        got = dist.pad_for_mesh(w, mesh)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        got_t = dist.pad_for_mesh(torch.from_numpy(w), mesh)
        assert got_t.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernel-wrapper"])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_sharded_closures_match_dense(shape, schedule, use_kernels):
    h, w = _line_graph()
    oracle = mr_matrix(h, device="cpu").astype(np.float32)
    got = dist.sharded_maxmin_closure(w, _mesh(shape), schedule=schedule,
                                      use_kernels=use_kernels)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.numpy().tobytes() == oracle.tobytes()
    # int32 in, int32 out: the dtype of the line graph is kept
    got32 = dist.sharded_maxmin_closure(w.astype(np.int32), _mesh(shape),
                                        schedule=schedule,
                                        use_kernels=use_kernels)
    assert got32.dtype == torch.int32
    assert np.array_equal(got32.numpy(), oracle.astype(np.int32))


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
@pytest.mark.parametrize("shape", GRIDS, ids=GRID_IDS)
def test_capped_rounds_equal_the_reference(shape, schedule, rounds):
    """A capped ladder leaves an intermediate R that only a functional
    round reproduces: every block of a round must read the old R (the
    port writes a second buffer).  The reference's rounds on its one host
    device are the yardstick — the grid does not change a round's
    result."""
    _, w = _line_graph(seed=11)
    want = np.asarray(ref_dist.sharded_maxmin_closure(
        w, ref_make_mesh((1, 1), ("data", "model")), rounds=rounds))
    got = dist.sharded_maxmin_closure(w, _mesh(shape), rounds=rounds,
                                      schedule=schedule, use_kernels=True)
    assert got.numpy().tobytes() == want.tobytes()


def test_closure_never_writes_its_input():
    _, w = _line_graph()
    kept = w.copy()
    wt = torch.from_numpy(w.copy())
    dist.sharded_maxmin_closure(w, _mesh((2, 2)), schedule="ring")
    dist.sharded_maxmin_closure(wt, _mesh((1, 1)))
    assert np.array_equal(w, kept) and np.array_equal(wt.numpy(), kept)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
@pytest.mark.parametrize("shape", GRIDS + [(2, 3)],
                         ids=GRID_IDS + ["2x3"])
def test_round_contracts_each_block_from_its_panels(monkeypatch, shape,
                                                    schedule):
    """One round calls the kernel wrapper r·c times (allgather: row panel
    [mp/r, mp] x column panel [mp, mp/c]) or r·c·r times (ring:
    [mp/r, mp/r] x [mp/r, mp/c] segments), always on contiguous
    operands."""
    calls = []
    real = mm.maxmin_matmul

    def spy(a, b, **kw):
        assert a.is_contiguous() and b.is_contiguous()
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(a, b, **kw)
    monkeypatch.setattr(mm, "maxmin_matmul", spy)
    r, c = shape
    mp = 12
    w = torch.from_numpy(np.random.default_rng(0).integers(
        0, 5, (mp, mp)).astype(np.float32))
    round_fn = dist.sharded_maxmin_round(_mesh(shape), schedule=schedule,
                                         use_kernels=True)
    out = round_fn(w)
    want = torch.maximum(w, mm.maxmin_matmul_ref(w, w))
    assert torch.equal(out, want)
    if schedule == "allgather":
        assert calls == [((mp // r, mp), (mp, mp // c))] * (r * c)
    else:
        assert calls == [((mp // r, mp // r), (mp // r, mp // c))] \
            * (r * c * r)


@pytest.mark.parametrize("grid", [(1, 2, 2), (2, 2, 2), (3, 1, 2)],
                         ids=["1x2x2", "2x2x2", "3x1x2"])
def test_sharded_threshold_closure_matches_dense(monkeypatch, grid):
    """The pod axis splits the threshold batch (padded with copies of the
    smallest threshold); each round is one ``threshold_step`` call per
    pod slice over the padded square slab."""
    h, w = _line_graph()
    oracle = mr_matrix(h, device="cpu").astype(np.float32)
    thr = distinct_thresholds(w)
    calls = []
    real = dist.threshold_step

    def spy(r):
        calls.append(tuple(r.shape))
        return real(r)
    monkeypatch.setattr(dist, "threshold_step", spy)
    mesh = _mesh(grid, ("pod", "data", "model"))
    got = dist.sharded_threshold_closure_mr(w, thr, mesh)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == oracle.tobytes()
    pod = grid[0]
    lcm = int(np.lcm(grid[1], grid[2]))
    mp = -(-w.shape[0] // lcm) * lcm
    per_pod = -(-thr.size // pod)
    rounds = max(1, int(np.ceil(np.log2(mp))))
    assert calls == [(per_pod, mp, mp)] * (pod * rounds)
    ref = np.asarray(ref_dist.sharded_threshold_closure_mr(
        w, thr, ref_make_mesh((1, 1, 1), ("pod", "data", "model"))))
    assert got.numpy().tobytes() == ref.tobytes()


_PADDED_REFERENCE_CODE = """
import sys
import numpy as np
from repro.core import random_hypergraph
from repro.core.distributed import sharded_maxmin_closure
from repro.launch.mesh import make_test_mesh

out = {}
h = random_hypergraph(30, 25, seed=3)       # m = 25 pads to 26
w = h.line_graph(np.int32).astype(np.float32)
for shape in ((1, 2), (2, 2)):
    mesh = make_test_mesh(shape, ("data", "model"))
    for sched in ("allgather", "ring"):
        for rounds in (None, 1):
            key = f"{shape[0]}x{shape[1]}-{sched}-{rounds}"
            out[key] = np.asarray(sharded_maxmin_closure(
                w, mesh, schedule=sched, rounds=rounds, trim=False))
np.savez(sys.argv[1], w=w, **out)
print("SAVED", len(out))
"""


def test_padded_closure_byte_equal_to_the_reference_on_host_devices(
        tmp_path):
    """The reference on four host devices (a subprocess: the device count
    is fixed before JAX starts) writes its padded W* (``trim=False``) for
    1 x 2 and 2 x 2 meshes, both schedules, full and one-round ladders;
    the port's on the logical grids of the same shapes is byte-equal."""
    path = tmp_path / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _PADDED_REFERENCE_CODE,
                          str(path)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "SAVED 8" in out.stdout, out.stderr
    ref = np.load(path)
    w = ref["w"]
    h = random_hypergraph(30, 25, seed=3)
    assert np.array_equal(h.line_graph(np.int32).astype(np.float32), w)
    for shape in ((1, 2), (2, 2)):
        for sched in ("allgather", "ring"):
            for rounds in (None, 1):
                key = f"{shape[0]}x{shape[1]}-{sched}-{rounds}"
                got = dist.sharded_maxmin_closure(
                    w, _mesh(shape), schedule=sched, rounds=rounds,
                    trim=False, use_kernels=True).numpy()
                want = ref[key]
                lcm = int(np.lcm(*shape))
                assert got.shape == want.shape == (-(-25 // lcm) * lcm,) * 2

                assert got.dtype == want.dtype and \
                    got.tobytes() == want.tobytes(), key


@pytest.mark.gpu
def test_float32_kernel_rounds_on_the_card_equal_the_plain_rounds():
    from repro_torch.device import gpu_probe
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    h, w = _line_graph()
    mesh = make_mesh((2, 2), ("data", "model"), device="cuda")
    before = mm.LAUNCHES
    got = dist.sharded_maxmin_closure(w, mesh, schedule="ring",
                                      use_kernels=True)
    rounds = max(1, int(np.ceil(np.log2(w.shape[0]))))
    assert mm.LAUNCHES - before == 2 * 2 * 2 * rounds
    plain = dist.sharded_maxmin_closure(w, mesh, schedule="ring")
    assert torch.equal(got, plain)
    assert np.array_equal(got.cpu().numpy(),
                          mr_matrix(h, device="cpu").astype(np.float32))
