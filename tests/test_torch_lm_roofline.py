"""Port parity, the LM roofline: the LM half of
``repro_torch.benchmarks.roofline`` against the reference's top-level
``benchmarks/roofline.py``.

``analytic_cell_model`` equals the reference's, float for float, on all
ten full configs at the four shapes.  ``roofline_row``, with the port's
three rates set to the reference's TPU v5e constants (197e12 FLOP/s,
819e9 B/s, 50e9 B/s), equals the reference's row on the reference's own
dry-run records (made in one subprocess on 512 host devices at smoke
widths); at the port's H100 rates its terms scale by 197/989, 819/3350
and 1.  ``roofline_table`` and ``format_table`` read the files the
dry-run's ``main`` wrote, in both packages."""
import dataclasses
import json
import pathlib
import sys

import pytest

import repro.configs as ref_configs
import repro.launch.shapes as ref_shapes
from repro_torch import configs as port_configs
from repro_torch.benchmarks import roofline
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as port_shapes

from util_subproc import run_with_devices

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import roofline as ref_roofline  # noqa: E402

# the reference's rates (a TPU v5e's), used here only to rescale
REF_RATES = {"PEAK_FLOPS": 197e12, "HBM_BW": 819e9, "LINK_BW": 50e9}
CELLS = [("qwen3-1.7b", "train_4k", False), ("qwen3-1.7b", "prefill_32k",
                                             False),
         ("qwen3-1.7b", "decode_32k", False),
         ("falcon-mamba-7b", "long_500k", True),
         ("recurrentgemma-2b", "decode_32k", False)]

_REFERENCE = """
import dataclasses, json, os, runpy, sys
from repro.configs import get_smoke_config
from repro.launch.dryrun import lower_cell
recs = []
for arch, shape, mp in CELLS:
    sm = get_smoke_config(arch)
    ov = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
    recs.append(lower_cell(arch, shape, multi_pod=mp, overrides=ov))
with open(os.path.join(OUT, "records.json"), "w") as f:
    json.dump(recs, f)
sys.argv = ["dryrun", "--arch", "falcon-mamba-7b", "--both-meshes",
            "--out", os.path.join(OUT, "main"), "--set", SET]
runpy.run_module("repro.launch.dryrun", run_name="__main__")
"""


def _smoke_set(arch):
    full, sm = port_configs.get_config(arch), \
        port_configs.get_smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if getattr(sm, f.name) != getattr(full, f.name)
            and not isinstance(getattr(sm, f.name), tuple)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_lm_roofline")
    head = (f"CELLS = {CELLS!r}\nOUT = {str(out)!r}\n"
            f"SET = {json.dumps(_smoke_set('falcon-mamba-7b'))!r}\n")
    run_with_devices(head + _REFERENCE, n_devices=512, timeout=300)
    return json.loads((out / "records.json").read_text()), out / "main"


def _rates(monkeypatch, rates):
    for name, value in rates.items():
        monkeypatch.setattr(roofline, name, value)


@pytest.mark.parametrize("shape", list(ref_shapes.SHAPES))
@pytest.mark.parametrize("arch", list(ref_configs.ALIASES))
def test_analytic_cell_model_equals_the_reference(arch, shape):
    want = ref_roofline.analytic_cell_model(ref_configs.get_config(arch),
                                            ref_shapes.SHAPES[shape])
    got = roofline.analytic_cell_model(port_configs.get_config(arch),
                                       port_shapes.SHAPES[shape])
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in
                                               want.values()]


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_roofline_row_at_the_reference_rates_equals_the_reference(
        reference, monkeypatch, i):
    rec = reference[0][i]
    _rates(monkeypatch, REF_RATES)
    want = ref_roofline.roofline_row(rec)
    got = roofline.roofline_row(rec)
    assert list(got) == list(want)
    assert got == want


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_terms_scale_to_the_h100_rates(reference, i):
    rec = reference[0][i]
    want, got = ref_roofline.roofline_row(rec), roofline.roofline_row(rec)
    assert got["t_compute_s"] == pytest.approx(
        want["t_compute_s"] * 197 / 989, rel=1e-12)
    assert got["t_memory_s"] == pytest.approx(
        want["t_memory_s"] * 819 / 3350, rel=1e-12)
    assert got["t_collective_s"] == want["t_collective_s"]
    assert got["exec_flops"] == want["exec_flops"]


def test_the_rates_are_the_h100_constants():
    assert roofline.PEAK_FLOPS == roofline.BF16_TENSOR_OPS_PER_S == 989e12
    assert roofline.HBM_BW == roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.LINK_BW == roofline.INTER_NODE_BYTES_PER_S == 50e9


def test_a_record_that_is_not_ok_has_no_row(reference):
    assert roofline.roofline_row({"status": "skipped"}) is None
    assert roofline.roofline_row({"status": "error"}) is None


def test_tables_over_the_reference_files_equal_the_reference(
        reference, monkeypatch):
    """The reference's ``main`` wrote ``falcon-mamba-7b``'s eight records;
    both packages' tables over them agree at the reference's rates."""
    ref_dir = str(reference[1])
    _rates(monkeypatch, REF_RATES)
    for mesh in ("sp", "mp"):
        want = ref_roofline.roofline_table(ref_dir, mesh)
        got = roofline.roofline_table(ref_dir, mesh)
        assert len(got) == 4 and got == want
        assert roofline.format_table(got) == ref_roofline.format_table(want)


def test_tables_over_the_files_main_wrote(tmp_path, capsys):
    recs = dryrun.main(["--arch", "qwen3-1.7b", "--both-meshes", "--out",
                        str(tmp_path), "--device", "cpu"])
    assert [r["status"] for r in recs].count("ok") == 6
    rows = roofline.roofline_table(str(tmp_path), "sp")
    assert [r["shape"] for r in rows] == ["decode_32k", "prefill_32k",
                                          "train_4k"]
    assert rows == [roofline.roofline_row(json.loads(p.read_text())) for p in
                    sorted(tmp_path.glob("*__sp.json"))
                    if "long_500k" not in p.name]
    text = roofline.format_table(rows).splitlines()
    assert text[0].startswith("arch") and len(text) == 2 + len(rows)
    assert all(r["dominant"] in ("compute", "memory", "collective")
               for r in rows)
    roofline.main(["--dir", str(tmp_path), "--mesh", "mp"])
    written = json.loads((tmp_path / "roofline_mp.json").read_text())
    assert written == json.loads(json.dumps(
        roofline.roofline_table(str(tmp_path), "mp")))
    assert "wrote" in capsys.readouterr().out


def test_star_import_gives_every_listed_name():
    names = {}
    exec("from repro_torch.benchmarks.roofline import *", names)
    assert set(roofline.__all__) <= set(names)
    assert "CHIPS" not in roofline.__all__
    for name in ("analytic_cell_model", "roofline_row", "roofline_table",
                 "format_table", "PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        assert name in roofline.__all__
