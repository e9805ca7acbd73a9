"""Port parity, the launchers: ``repro_torch.launch`` against
``repro.launch``.

The reference's closure dry-run must see 512 host devices, which
``XLA_FLAGS`` fixes before JAX first starts, so it runs in a subprocess
(``util_subproc.run_with_devices``) at m = 256 and at the production
m = 65,536 (it only lowers and compiles).  The port's ``main`` runs here
on the CPU: at m = 256 with its rounds run (the kernels' plain versions)
and at m = 65,536 for the analytic fields only.  The records have the
same file tags and carry every key of the reference's; the analytic
fields and the collective count are equal, values and JSON types; what
the port cannot have (nothing is lowered or compiled) is ``null``.  The
rounds at m = 256 are held to ``core/semiring.py``'s closure round in
both packages.  The mesh and the shape cells equal the reference's."""
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.semiring as ref_sr
import repro.launch.shapes as ref_shapes
from repro_torch import configs as port_configs
from repro_torch import launch as port_launch
from repro_torch.benchmarks import roofline
from repro_torch.core import semiring as port_sr
from repro_torch.kernels import threshold_closure as tc
from repro_torch.launch import closure_dryrun as cd

from util_subproc import run_with_devices

ANALYTIC = ("kind", "m", "S", "multi_pod", "schedule", "dtype", "n_devices",
            "flops_analytic", "hbm_bytes", "collective_executed")
NOT_LOWERED = ("lower_s", "compile_s", "hlo_flops_per_dev")
PORT_ONLY_ANALYTIC = {"rate_ops_per_s", "rate_of", "link_bytes_per_s",
                      "device"}
PORT_ONLY_RUN = {"run_s", "run_bound_s", "peak_bytes", "run_of", "launches",
                 "max_abs_err", "sample", "data"}
TAGS = [cd.cell_tag(*cell) for cell in cd.CELLS]
SIZES = (256, 65536)

_REFERENCE = """
import json, os, runpy, sys
out = sys.argv[1]
for m in ("256", "65536"):
    sys.argv = ["closure_dryrun", "--m", m, "--out", os.path.join(out, m)]
    runpy.run_module("repro.launch.closure_dryrun", run_name="__main__")
from repro.launch.mesh import make_production_mesh, make_test_mesh
meshes = {}
for name, mesh in (("sp", make_production_mesh()),
                   ("mp", make_production_mesh(multi_pod=True)),
                   ("test", make_test_mesh())):
    meshes[name] = [list(mesh.axis_names), dict(mesh.shape),
                    int(mesh.devices.size)]
print("MESHES " + json.dumps(meshes))
"""


def _records(root: pathlib.Path):
    return {p.stem: json.loads(p.read_text())
            for p in sorted(root.glob("*.json"))}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dryrun")
    stdout = run_with_devices(
        "import sys; sys.argv = ['x', %r]\n" % str(out) + _REFERENCE,
        n_devices=512, timeout=300)
    meshes = json.loads(stdout.split("MESHES ", 1)[1].splitlines()[0])
    return {m: _records(out / str(m)) for m in SIZES}, meshes


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("port_dryrun")
    small = cd.main(["--m", "256", "--device", "cpu",
                     "--out", str(out / "256")])
    big = cd.main(["--device", "cpu", "--no-run",
                   "--out", str(out / "65536")])
    assert all(r["status"] == "ok" for r in small + big)
    return {m: _records(out / str(m)) for m in SIZES}


def test_same_file_tags_as_the_reference(reference, port):
    for m in SIZES:
        assert sorted(port[m]) == sorted(reference[0][m]) == sorted(TAGS)


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("tag", TAGS)
def test_analytic_fields_and_collectives_equal_the_reference(reference,
                                                             port, tag, m):
    want, got = reference[0][m][tag], port[m][tag]
    assert want["status"] == got["status"] == "ok"
    for key in ANALYTIC:
        assert got[key] == want[key], key
        assert type(got[key]) is type(want[key]), key
    for kind in cd.COLLECTIVE_KINDS:
        for part in ("bytes", "counts"):
            assert type(got["collective_executed"][part][kind]) is int


@pytest.mark.parametrize("m", SIZES)
@pytest.mark.parametrize("tag", TAGS)
def test_records_keep_every_reference_key(reference, port, tag, m):
    want, got = reference[0][m][tag], port[m][tag]
    assert list(got)[:len(want)] == list(want)
    extra = set(got) - set(want)
    run_keys = PORT_ONLY_RUN | ({"slice_s"} if got["kind"] != "maxmin"
                                else set())
    assert extra == (PORT_ONLY_ANALYTIC | run_keys if m == 256
                     else PORT_ONLY_ANALYTIC)
    for key in NOT_LOWERED:
        assert want[key] is not None and got[key] is None, key


@pytest.mark.parametrize("tag", TAGS)
def test_pricing_uses_the_h100_rates(port, tag):
    rec = port[65536][tag]
    n_dev = rec["n_devices"]
    if rec["kind"] == "maxmin":
        rate = roofline.minmax_rate()
    else:        # 0/1 operands run in bf16 whatever the cell's dtype
        rate = roofline.BF16_TENSOR_OPS_PER_S
    assert rec["rate_ops_per_s"] == rate
    assert rec["t_compute_s"] == rec["flops_analytic"] / (n_dev * rate)
    assert rec["t_memory_s"] == rec["hbm_bytes"] / (
        n_dev * roofline.HBM_BYTES_PER_S)
    assert rec["t_collective_s"] == rec["collective_executed"][
        "total_bytes"] / roofline.INTER_NODE_BYTES_PER_S == \
        rec["collective_executed"]["total_bytes"] / 50e9
    terms = dict(compute=rec["t_compute_s"], memory=rec["t_memory_s"],
                 collective=rec["t_collective_s"])
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["mfu_bound"] == (0.0 if rec["kind"] == "maxmin" else
                                rec["t_compute_s"] / max(terms.values()))


def test_runs_are_shared_between_cells_of_one_computation(port):
    recs = port[256]
    assert {tag: recs[tag]["run_of"] for tag in TAGS} == {
        "maxmin__sp__allgather__float32": "maxmin__sp__allgather__float32",
        "maxmin__sp__ring__float32": "maxmin__sp__ring__float32",
        "threshold__sp__allgather__float32":
            "threshold__sp__allgather__float32",
        "threshold__mp__allgather__float32":
            "threshold__sp__allgather__float32",
        "threshold__sp__allgather__bfloat16":
            "threshold__sp__allgather__float32",
        "bisection__sp__allgather__float32":
            "bisection__sp__allgather__float32",
        "bisection__sp__allgather__bfloat16":
            "bisection__sp__allgather__float32",
        "bisection__mp__allgather__bfloat16":
            "bisection__sp__allgather__float32",
    }
    for rec in recs.values():
        # off the card: no device time, no device peak, no kernel launch
        assert rec["run_s"] is None and rec["peak_bytes"] is None
        assert rec.get("slice_s", [None]) == [None] * len(
            rec.get("slice_s", [None]))
        assert rec["launches"] == {} and rec["max_abs_err"] == 0.0
        assert rec["sample"] == [64, 64]
        assert rec["data"]["m"] == 256 and rec["data"]["n"] == 347
    m = 256
    assert recs["maxmin__sp__ring__float32"]["run_bound_s"] == max(
        2.0 * m ** 3 / roofline.minmax_rate(),
        8 * m * m / roofline.HBM_BYTES_PER_S)
    assert recs["threshold__sp__allgather__float32"]["run_bound_s"] == max(
        2.0 * 32 * m ** 3 / roofline.BF16_TENSOR_OPS_PER_S,
        4 * 32 * m * m / roofline.HBM_BYTES_PER_S)


def test_thresholds_of_each_boolean_cell():
    assert cd.thresholds_of("threshold", 32) == list(range(1, 33))
    assert cd.thresholds_of("bisection", 32) == [1, 2, 4, 8, 16, 32]
    assert cd.thresholds_of("bisection", 20) == [1, 2, 4, 8, 16, 20]
    assert cd.thresholds_of("bisection", 1) == [1]


def test_production_graph_is_walmart_trips_cut_to_m():
    assert cd.dryrun_graph_params(65536) == dict(
        n=89_000, m=65_536, min_size=2, max_size=8, seed=6)
    assert cd.dryrun_graph_params(256)["n"] == 89_000 * 256 // 65_536


@pytest.fixture(scope="module")
def line_graph():
    w, data = cd.dryrun_line_graph(256, device="cpu")
    return w


def test_line_graph_is_the_hypergraphs(line_graph):
    from repro_torch.core.hypergraph import random_hypergraph
    h = random_hypergraph(**cd.dryrun_graph_params(256))
    assert line_graph.dtype == torch.float32
    np.testing.assert_array_equal(line_graph.numpy(),
                                  h.line_graph(np.float32))


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_maxmin_round_equals_the_semiring_round(line_graph, schedule):
    got = cd.maxmin_round(line_graph, schedule)
    want = port_sr.maxmin_closure(line_graph, max_rounds=1)
    assert torch.equal(got, want)
    ref = ref_sr.maxmin_closure(jnp.asarray(line_graph.numpy()),
                                max_rounds=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got > line_graph).any()          # the round adds paths


@pytest.mark.parametrize("t", [1, 2, 3])
def test_threshold_slice_round_equals_the_boolean_round(line_graph, t):
    r = cd.threshold_slice(line_graph, float(t))
    assert r.dtype == torch.bfloat16 and tuple(r.shape) == (1, 256, 256)
    adj = ((line_graph >= t).float() + torch.eye(256)).clamp(max=1)
    got = tc.threshold_step(r)
    want = port_sr.boolean_closure(adj, rounds=1)
    assert torch.equal(got[0].float(), want)
    ref = ref_sr.boolean_closure(jnp.asarray(adj.numpy()), rounds=1)
    np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(ref))


def test_production_mesh_equals_the_reference(reference):
    meshes = reference[1]
    sp = port_launch.make_production_mesh(device="cpu")
    mp = port_launch.make_production_mesh(multi_pod=True, device="cpu")
    test = port_launch.make_test_mesh(device="cpu")
    for name, mesh in (("sp", sp), ("mp", mp), ("test", test)):
        assert [list(mesh.axis_names), dict(mesh.shape),
                int(mesh.devices.size)] == meshes[name]
    assert sp.dims == (16, 16) and mp.dims == (2, 16, 16)
    assert sp.device.type == "cpu"


def test_production_mesh_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_launch.make_production_mesh()


def test_shape_cells_equal_the_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in port_launch.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in ref_shapes.SHAPES.items()}
    got = port_launch.all_cells(port_configs.ARCH_IDS,
                                port_configs.get_config)
    want = ref_shapes.all_cells(ref_configs.ARCH_IDS, ref_configs.get_config)
    assert got == want and len(got) == 40
    runs = sum(1 for *_, ok, _ in got if ok)
    assert runs == 32
    for arch in port_configs.ARCH_IDS:
        for shape in port_launch.SHAPES.values():
            assert port_launch.cell_applicable(
                port_configs.get_config(arch), shape) == \
                ref_shapes.cell_applicable(ref_configs.get_config(arch),
                                           ref_shapes.SHAPES[shape.name])


def test_link_rates_are_the_stated_ones():
    assert roofline.INTER_NODE_BYTES_PER_S == 400e9 / 8
    assert roofline.NVLINK_BYTES_PER_S == 900e9 / 2
    assert math.isclose(roofline.int32_minmax_rate(132, 1980),
                        16.72704e12)
