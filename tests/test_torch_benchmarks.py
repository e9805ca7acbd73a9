"""The port's benchmark suite against the reference's, on the CPU at small
sizes: the datasets byte for byte, the bound helpers against the numbers
``chip_smoke.py``'s inline helpers gave before they moved, the JSON keys
of every ``bench_*`` script against the reference's own output files
(``BENCH_*.json``, written by the reference's scripts), and
``kernels_bench`` on the host saying so."""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import datasets as ref_datasets  # noqa: E402
from repro.core import random_hypergraph as ref_random_hypergraph  # noqa: E402

from repro_torch.benchmarks import (bench_construction,  # noqa: E402
                                    bench_maintenance, bench_persistence,
                                    bench_service_scale, bench_serving,
                                    bench_sharded, bench_workloads,
                                    datasets, kernels_bench, roofline)
from repro_torch.benchmarks.common import OUT_DIR, default_out  # noqa: E402
from repro_torch.benchmarks.run import print_csv  # noqa: E402

CSR = ("e_ptr", "e_idx", "v_ptr", "v_idx")


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    for f in CSR:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


# -- datasets ------------------------------------------------------------------

@pytest.mark.parametrize("name", [*ref_datasets.BENCH_DATASETS, "CHAIN",
                                  "COLO"])
def test_dataset_equals_the_reference_byte_for_byte(name):
    _same_csr(datasets.make_dataset(name), ref_datasets.make_dataset(name))


def test_dataset_table_is_the_reference_table():
    assert datasets.BENCH_DATASETS == ref_datasets.BENCH_DATASETS


@pytest.mark.parametrize("name,size,short", [
    ("PS", (242, 12_704), "PS-s"), ("EE", (998, 25_800), "EE-s"),
    ("WA", (89_000, 70_000), "WA-s")])
def test_published_rows_keep_the_stand_ins_edge_sizes_and_seeds(name, size,
                                                                short):
    p = datasets.dataset_params(name)
    _, _, _, lo, hi, seed = ref_datasets.BENCH_DATASETS[short]
    assert (p["n"], p["m"]) == size
    assert (p["min_size"], p["max_size"], p["seed"]) == (lo, hi, seed)


@pytest.mark.parametrize("name", ["PS", "EE"])
def test_published_dataset_equals_the_reference_generator(name):
    p = datasets.dataset_params(name)
    _same_csr(datasets.make_dataset(name),
              ref_random_hypergraph(p["n"], p["m"], min_size=p["min_size"],
                                    max_size=p["max_size"], seed=p["seed"]))


def test_chip_smoke_takes_its_graphs_from_the_datasets():
    import chip_smoke
    assert chip_smoke.CLOSURE_GRAPH == dict(n=242, m=12_704, min_size=2,
                                            max_size=5, seed=4)
    assert chip_smoke.SMALL_GRAPH == dict(n=200, m=256, min_size=2,
                                          max_size=6, seed=7)
    assert chip_smoke.EMAIL_EU == dict(n=998, m=25_800, min_size=2,
                                       max_size=6, seed=5)
    assert chip_smoke.MAIN_GRAPH == dict(n=89_000, m=70_000, min_size=2,
                                         max_size=8, seed=6)
    assert chip_smoke.RATES is roofline.RATES


# -- the bound helpers: equal to what chip_smoke.py's inline copies gave -------

# an H100 SXM: 132 SMs at 1,980 MHz
_RATE = 132 * 64 * 1980.0 * 1e6


@pytest.fixture
def rates(monkeypatch):
    monkeypatch.setitem(roofline.RATES, "int32_minmax", _RATE)


def test_int32_rate_and_fill_rates(monkeypatch):
    monkeypatch.setattr(roofline, "RATES", {})
    got = roofline.fill_rates(132, 1980.0)
    assert roofline.RATES["int32_minmax"] == _RATE
    assert got == {"sms": 132, "max_sm_clock_mhz": 1980.0,
                   "int32_minmax_ops_per_s": _RATE}
    assert roofline.int32_minmax_rate(132, 1980.0) == _RATE


def test_dense_bounds_equal_the_old_inline_helpers(rates):
    assert roofline.bound(1e9, 1e12, 1e15) == (1.0, "operations")
    assert roofline.bound(1e6, 1e13, _RATE) == (597.8344046525864,
                                                "operations")
    assert roofline.maxmin_bound(12704, 12704, 12704) == (
        245.1502584634221, "operations")
    assert roofline.maxmin_bound(6352, 12704, 6352) == (61.28756461585552,
                                                        "operations")
    assert roofline.maxmin_bound(2048, 2048, 2048) == (1.0270716865625957,
                                                       "operations")
    assert roofline.overlap_bound(12704, 242, 2) == (0.19454185074626865,
                                                     "bytes")
    assert roofline.overlap_bound(2048, 512, 2) == (0.0056341397014925375,
                                                    "bytes")
    assert roofline.threshold_bound(5, 12704, 2) == (10.360379432359778,
                                                     "operations")
    assert roofline.threshold_bound(5, 2048, 2) == (0.04340542997473471,
                                                    "operations")
    assert roofline.bf16_ceiling_ms(2 * 5 * 12704 ** 3) == 20.731234475874622


def test_overlap_rows_bound_counts_both_operands_and_the_rows(rates):
    """A rank's rows of W at primary-school's shape: both operands read
    once in bf16 and its [3,176, 12,704] float32 rows written once; the
    whole square is ``overlap_bound`` plus one more read of B."""
    ma, mb, n = 3176, 12704, 242
    nbytes = 2 * (ma + mb) * n + 4 * ma * mb
    assert roofline.overlap_rows_bound(ma, mb, n, 2) == (
        nbytes / roofline.HBM_BYTES_PER_S * 1e3, "bytes")
    whole = roofline.overlap_rows_bound(mb, mb, n, 2)[0]
    assert whole == pytest.approx(
        roofline.overlap_bound(mb, n, 2)[0]
        + 2 * mb * n / roofline.HBM_BYTES_PER_S * 1e3, rel=1e-12)


def test_label_join_bounds_equal_the_old_inline_helpers(rates):
    g = torch.Generator().manual_seed(3)
    su = torch.randint(0, 3, (1000, 15), generator=g, dtype=torch.int32)
    assert roofline.label_join_bound(su, 1000, 15) == (7.283582089552239e-05,
                                                       "bytes")
    assert roofline.label_join_bound(su[:0], 0, 15) == (0.0, "bytes")
    assert roofline.label_join_bound(su[:, :0], 1000, 0) == (
        1.1940298507462686e-06, "bytes")
    svals = torch.randint(0, 3, (500, 16), generator=g, dtype=torch.int32)
    us = torch.randint(0, 500, (4096,), generator=g)
    vs = torch.randint(0, 500, (4096,), generator=g)
    assert roofline.label_join_gather_bound(svals, us, vs) == (
        4.3558208955223884e-05, "bytes",
        {"bytes": 145920, "distinct_rows": 500})


def test_sweep_bound_equals_the_old_inline_helper():
    rec = {"queries": 1024, "chunk_queries": 300, "rounds": [3, 5, 2, 7],
           "alive_edges": 123456}
    assert roofline.sweep_bound_bytes(rec, 25800) == 224773824


# -- the scripts' JSON keys against the reference's BENCH_*.json ---------------

def _shape(doc):
    """Top-level keys; keys of each dict value; keys of the first row of
    each list-of-dicts value."""
    out = {}
    for k, v in doc.items():
        if isinstance(v, dict):
            out[k] = sorted(v)
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out[k] = [sorted(v[0])]
        else:
            out[k] = None
    return out


def _reference_shape(name):
    with open(ROOT / f"BENCH_{name}.json") as f:
        return _shape(json.load(f))


# what the port's documents add to the reference's, by script
EXTRA = {"construction": {"results": ["pool_fallback"]},
         "sharded": {"results": ["layout"]}}

RUNS = {
    "serving": lambda out: bench_serving.run(
        200, 80, 200, 50, 3, 5, out, enforce_speedup=False, device="cpu"),
    "service_scale": lambda out: bench_service_scale.run(
        120, 50, 300, 200, 8, 64, (2,), (1, 2), ("uniform",), out,
        device="cpu"),
    "workloads": lambda out: bench_workloads.sweep([(20, 30)], 3, 1, out,
                                                   device="cpu"),
    "persistence": lambda out: bench_persistence.sweep([(60, 75)], 3, 10, out,
                                                       device="cpu"),
    "maintenance": lambda out: bench_maintenance.sweep(
        [2], 4, 1, 10, out, sharded_chain_len=3, device="cpu"),
    "construction": lambda out: bench_construction.run(
        [(2, 30, 20)], 1, 10, out, workers=2, quick=True, device="cpu"),
    "sharded": lambda out: bench_sharded.sweep("ENG-s", 16, [1, 2], out,
                                               device="cpu"),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_bench_json_keys_are_the_reference_keys_plus_env(name, tmp_path):
    out = str(tmp_path / f"BENCH_{name}.json")
    doc = RUNS[name](out)
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(doc))
    got, want = _shape(doc), _reference_shape(name)
    assert set(got) == set(want) | {"env"}
    assert doc["env"]["device"] == "cpu" and doc["env"]["torch"]
    for key, keys in want.items():
        extra = EXTRA.get(name, {}).get(key, [])
        if isinstance(keys, list) and keys and isinstance(keys[0], list):
            assert got[key] == [sorted(keys[0] + extra)], key
        else:
            assert got[key] == keys, key


def test_sharded_sweep_runs_every_layout_in_one_process(tmp_path):
    assert [bench_sharded.layout(b) for b in (1, 2, 4, 6)] == [
        (1, 1), (1, 2), (2, 2), (2, 3)]


def test_kernels_bench_on_the_host_says_cpu_and_gives_no_fraction(tmp_path):
    out = str(tmp_path / "BENCH_kernels.json")
    doc = kernels_bench.run(n=60, m=50, q=64, sample=16, mm=32,
                            out_path=out, device="cpu")
    assert doc["device"] == "cpu" and doc["env"]["device"] == "cpu"
    assert "interpret_mode" not in json.dumps(doc)
    for name in ("label_join", "maxmin_matmul", "overlap", "threshold_step"):
        row = doc[name]
        assert row["device"] == "cpu"
        assert "roofline" not in row
        assert row["bound_ms"] is None and row["bound_by"] is None
        assert row["kernel_ms"] > 0 and row["plain_ms"] > 0
    assert doc["overlap"]["library_ms"] > 0
    assert doc["threshold_step"]["library_ms"] > 0
    assert doc["label_join"]["library_ms"] is None
    assert doc["label_join"]["answers_verified"] == 64


def test_kernels_bench_gives_bound_and_fraction_where_rates_are_known(
        rates):
    row = kernels_bench._with_fraction(
        {"kernel_ms": 2.0, **kernels_bench._bound(
            torch.device("cuda"), lambda: roofline.maxmin_bound(64, 64, 64))})
    assert row["bound_by"] == "operations"
    assert row["roofline"]["fraction_of_bound"] == row["bound_ms"] / 2.0


def test_closure_bench_rows_equal_the_reference(tmp_path):
    from benchmarks import kernels_bench as ref_kb
    got = kernels_bench.closure_bench(m=32, device="cpu")
    want = ref_kb.closure_bench(m=32)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    assert [r[1] for r in got if r[2] == "Gops"] == \
        [r[1] for r in want if r[2] == "Gops"]


def test_csv_is_the_reference_format(capsys):
    print_csv([("a.b", 1, "count"), ("c", 2.34567, "per-query-us")])
    assert capsys.readouterr().out.splitlines() == [
        "name,value,unit", "a.b,1.000,count", "c,2.346,per-query-us"]


def test_default_output_is_under_build_and_never_the_reference_files():
    for name in ("kernels", "serving", "sharded"):
        path = pathlib.Path(default_out(name))
        assert path.parent == OUT_DIR == ROOT / "build" / "bench_torch"
        assert path.name == f"BENCH_{name}.json"
        assert path != ROOT / f"BENCH_{name}.json"
