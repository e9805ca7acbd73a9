"""Port parity, the LM dry-run: ``repro_torch.launch.dryrun`` against
``repro.launch.dryrun``.

The reference must see 512 host devices, which ``XLA_FLAGS`` fixes before
JAX first starts, so its ``lower_cell`` runs in one subprocess
(``util_subproc.run_with_devices``) at smoke widths (the SMOKE config's
fields as ``overrides``): one arch of each family on 16 x 16 at each
shape, two of them on 2 x 16 x 16 too, and ``qwen3-1.7b`` on the three
data-parallel meshes the card runs; then its ``main`` on one arch into an
``--out`` directory.  The port's records carry every key of the
reference's, with the same JSON types except the documented ``None``s,
and equal it in every exact field, ``memory.argument_bytes`` included.
Its collectives are a closed form (not XLA's), pinned here on a
hand-counted case.  The run path (``run=True``) runs on the CPU at smoke
widths on reduced shape cells."""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES, ShapeCell

from util_subproc import run_with_devices

FAMILIES = ("qwen3-1.7b", "qwen2-moe-a2.7b", "llava-next-mistral-7b",
            "falcon-mamba-7b", "recurrentgemma-2b", "whisper-large-v3")
MULTI_POD = ("qwen3-1.7b", "falcon-mamba-7b")
CARD_MESHES = (("train_4k", (64, 1)), ("prefill_32k", (32, 1)),
               ("decode_32k", (128, 1)))
CELLS = ([(a, s, False, None) for a in FAMILIES for s in SHAPES]
         + [(a, s, True, None) for a in MULTI_POD for s in SHAPES]
         + [("qwen3-1.7b", s, False, ms) for s, ms in CARD_MESHES])
IDS = [f"{a}-{s}-{'mp' if mp else 'sp'}{'-' + 'x'.join(map(str, ms)) if ms else ''}"
       for a, s, mp, ms in CELLS]
# the fields the port cannot have: nothing is lowered or compiled
NOT_LOWERED = ("lower_s", "compile_s", "flops", "bytes_accessed", "loops")
NOT_LOWERED_MEMORY = ("temp_bytes", "generated_code_bytes")
EXACT = ("arch", "shape", "multi_pod", "status", "reason", "mesh_shape",
         "n_devices", "model_params", "model_params_active")
PORT_ONLY = {"device"}
RUN_FIELDS = ("run_batch", "run_s", "run_times_s", "run_flops",
              "peak_bytes", "run_bound_s", "run_bound_by", "run_checks")


def _overrides(arch):
    sm = get_smoke_config(arch)
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}


def _main_overrides():
    """The fields by which ``qwen3-1.7b``'s SMOKE config differs from its
    full one (scalars: they go through ``--set`` as JSON)."""
    full, sm = get_config("qwen3-1.7b"), get_smoke_config("qwen3-1.7b")
    return {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)
            if getattr(sm, f.name) != getattr(full, f.name)}


_REFERENCE = """
import dataclasses, json, os, runpy, sys
from repro.configs import get_smoke_config
from repro.launch.dryrun import lower_cell
recs = []
for arch, shape, mp, ms in CELLS:
    sm = get_smoke_config(arch)
    ov = {f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}
    recs.append(lower_cell(arch, shape, multi_pod=mp, overrides=ov,
                           mesh_shape=tuple(ms) if ms else None))
with open(os.path.join(OUT, "records.json"), "w") as f:
    json.dump(recs, f)
sys.argv = ["dryrun", "--arch", "qwen3-1.7b", "--both-meshes", "--out",
            os.path.join(OUT, "main"), "--set", SET]
runpy.run_module("repro.launch.dryrun", run_name="__main__")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_lm_dryrun")
    head = (f"CELLS = {CELLS!r}\nOUT = {str(out)!r}\n"
            f"SET = {json.dumps(_main_overrides())!r}\n")
    run_with_devices(head + _REFERENCE, n_devices=512, timeout=400)
    recs = json.loads((out / "records.json").read_text())
    return dict(zip(IDS, recs)), out / "main"


@pytest.fixture(scope="module")
def port():
    recs = [dryrun.lower_cell(a, s, multi_pod=mp, overrides=_overrides(a),
                              mesh_shape=ms, device="cpu")
            for a, s, mp, ms in CELLS]
    return dict(zip(IDS, json.loads(json.dumps(recs))))


def _documented_none(rec, key) -> bool:
    """``memory.output_bytes`` is ``None`` only where no rule reproduces
    the reference's number (the module docstring's list)."""
    cfg = get_smoke_config(rec["arch"])
    if key == "output_bytes":
        return (cfg.family == "hybrid" and SHAPES[rec["shape"]].kind ==
                "decode") or (cfg.opt_8bit and rec["shape"] == "train_4k")
    return False


@pytest.mark.parametrize("cell", IDS)
def test_records_carry_every_reference_key(reference, port, cell):
    want, got = reference[0][cell], port[cell]
    assert list(got)[:len(want)] == list(want)
    assert set(got) - set(want) <= PORT_ONLY
    if want["status"] == "ok":
        assert list(got["memory"]) == list(want["memory"])
        for part in ("collective", "collective_executed"):
            assert list(got[part]) == ["bytes", "counts", "total_bytes"]
            for sub in ("bytes", "counts"):
                assert list(got[part][sub]) == list(want[part][sub]) == \
                    list(dryrun.COLLECTIVE_KINDS)


@pytest.mark.parametrize("cell", IDS)
def test_json_types_equal_the_reference_but_the_documented_nones(
        reference, port, cell):
    want, got = reference[0][cell], port[cell]
    if want["status"] != "ok":
        return
    for key, value in want.items():
        if key in NOT_LOWERED:
            assert value is not None and got[key] is None, key
        elif key != "memory":
            assert type(got[key]) is type(value), key
    for key, value in want["memory"].items():
        if key in NOT_LOWERED_MEMORY:
            assert got["memory"][key] is None, key
        elif got["memory"][key] is None:
            assert _documented_none(got, key), key
        else:
            assert type(got["memory"][key]) is type(value) is int, key
    for part in ("collective", "collective_executed"):
        assert type(got[part]["total_bytes"]) is int
        for sub in ("bytes", "counts"):
            assert all(type(v) is int for v in got[part][sub].values())


@pytest.mark.parametrize("cell", IDS)
def test_exact_fields_and_memory_equal_the_reference(reference, port, cell):
    """Status, reason (skipped cells), mesh, parameter counts, and the
    per-device argument and output bytes."""
    want, got = reference[0][cell], port[cell]
    for key in EXACT:
        assert got.get(key) == want.get(key), key
    if want["status"] == "ok":
        assert got["memory"]["argument_bytes"] == \
            want["memory"]["argument_bytes"]
        if not _documented_none(got, "output_bytes"):
            assert got["memory"]["output_bytes"] == \
                want["memory"]["output_bytes"]


def test_the_same_cells_are_skipped_for_the_same_reason(reference, port):
    skipped = {c for c in IDS if reference[0][c]["status"] == "skipped"}
    assert skipped == {c for c in IDS if port[c]["status"] == "skipped"}
    assert skipped == {c for c in IDS if "long_500k" in c and not any(
        a in c for a in ("falcon-mamba-7b", "recurrentgemma-2b"))}


def test_main_writes_the_reference_files_and_keys(reference, tmp_path):
    ref_dir = reference[1]
    dryrun.main(["--arch", "qwen3-1.7b", "--both-meshes", "--out",
                 str(tmp_path), "--set", json.dumps(_main_overrides()),
                 "--device", "cpu"])
    names = sorted(p.name for p in ref_dir.glob("*.json"))
    assert names == sorted(p.name for p in tmp_path.glob("*.json"))
    assert len(names) == 8 and names[0] == "qwen3_1_7b__decode_32k__mp.json"
    for name in names:
        want = json.loads((ref_dir / name).read_text())
        got = json.loads((tmp_path / name).read_text())
        assert set(want) <= set(got), name
        assert set(got) - set(want) <= PORT_ONLY, name
        for key in EXACT:
            assert got.get(key) == want.get(key), (name, key)
        if want["status"] == "ok":
            assert got["memory"]["argument_bytes"] == \
                want["memory"]["argument_bytes"]


def test_main_tags_and_skips_existing_records(tmp_path, capsys):
    args = ["--arch", "qwen3-1.7b", "--shape", "decode_32k", "--out",
            str(tmp_path), "--tag", "t1", "--device", "cpu", "--set",
            json.dumps(_main_overrides())]
    assert len(dryrun.main(args)) == 1
    assert [p.name for p in tmp_path.iterdir()] == \
        ["qwen3_1_7b__decode_32k__sp__t1.json"]
    assert dryrun.main(args + ["--skip-existing"]) == []
    assert "[cached ] qwen3-1.7b × decode_32k × 16x16" in \
        capsys.readouterr().out


def test_main_raises_on_a_failed_cell(tmp_path):
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "train_4k",
                     "--set", '{"family": "none"}', "--device", "cpu"])


# ---------------------------------------------------------------------------
# the collective closed form, counted by hand on the 2-layer dense smoke
# model (qwen3-1.7b's SMOKE: d_model 64, d_ff 128, vocab 256, 4 heads of
# 16, 2 KV heads, an untied vocab-split head, bf16 compute, remat "full",
# one microbatch) on a 2 x 2 (data, model) mesh
# ---------------------------------------------------------------------------

def _tally(**kinds):
    out = {"bytes": {k: 0 for k in dryrun.COLLECTIVE_KINDS},
           "counts": {k: 0 for k in dryrun.COLLECTIVE_KINDS}}
    for kind, (nbytes, count) in kinds.items():
        kind = kind.replace("_", "-")
        out["bytes"][kind], out["counts"][kind] = nbytes, count
    out["total_bytes"] = sum(out["bytes"].values())
    return out


def _hand_counted(kind):
    # partial sums cross in float32 (4 bytes), the embedding's exact sum
    # in bf16 (2)
    layers, d, a, f = 2, 64, 2, 4
    if kind == "train":
        t = 256 // 2 * 4096            # tokens a device holds (data 2)
        ar = t * d * f                 # one [t, d] partial-sum all-reduce
        body = 2 * 3                   # wo + down; forward, remat, backward
        status = 2 * 4                 # a float32 word beside each backward
        # embed; loss stats; input grad and its status word
        head = [t * d * a, 3 * t * 4, ar + 4]
        # once a step: the qk norms' partial gradients ([L, 16] each) over
        # model, the global norm's one value over the grid, the loss's
        # one value over data
        step = [2 * layers * 16 * 4, 4, 4]
        # every leaf is ZeRO-1-split over data: reduce-scatter to its
        # moment's float32 shard, all-gather of its own float32 shard
        # (embed, ln_f, ln1, wq, wk, wv, wo, q_norm, k_norm, ln2, gate,
        # up, down, lm_head)
        rs = [128 * 32, 32, 64, 64 * 32, 64 * 16, 64 * 16, 32 * 64, 16, 16,
              64, 64 * 64, 64 * 64, 64 * 64, 32 * 128]
        rs = [4 * n for n in rs]
        ag = [2 * n for n in rs]
        flat = _tally(all_reduce=(body * ar + status + sum(head)
                                  + sum(step), body + 5 + 3),
                      reduce_scatter=(sum(rs), 14),
                      all_gather=(sum(ag), 14))
        executed = _tally(all_reduce=(layers * (body * ar + status)
                                      + sum(head) + sum(step),
                                      layers * body + 5 + 3),
                          reduce_scatter=(sum(rs), 14),
                          all_gather=(sum(ag), 14))
        return flat, executed
    t = 32 // 2 * 32768 if kind == "prefill" else 128 // 2
    ar, emb = t * d * f, t * d * a
    if kind == "prefill":
        # wo + down a layer, the vocab-split embedding; the vocab-split
        # logits stay split (the step's result)
        return (_tally(all_reduce=(2 * ar + emb, 3)),
                _tally(all_reduce=(2 * layers * ar + emb, 2 * layers + 1)))
    # decode against a cache whose sequence is split over model, each
    # layer: the new q (4 heads), k and v (2 KV heads each) of 16 gathered
    # over model, 64 x 8 x 16 bf16; the scores' max and exponentials' sum,
    # 64 x 4 float32 each; the weighted values, 64 x 4 x 16 float32; then
    # wo and down; and the embedding once
    qkv = t * (4 + 2 + 2) * 16 * a
    stats, values = t * 4 * 4, t * 4 * 16 * f
    body = 2 * ar + 2 * stats + values
    return (_tally(all_gather=(qkv, 1), all_reduce=(body + emb, 6)),
            _tally(all_gather=(layers * qkv, layers),
                   all_reduce=(layers * body + emb, layers * 5 + 1)))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_collectives_equal_the_hand_count(shape):
    rec = dryrun.lower_cell("qwen3-1.7b", shape, mesh_shape=(2, 2),
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu")
    flat, executed = _hand_counted(SHAPES[shape].kind)
    assert rec["collective"] == flat
    assert rec["collective_executed"] == executed


def _moe_hand_counted(layout, kind):
    """The MoE terms on the 2-layer smoke models on 2 x 2 (``k`` = 2, d
    64, top 2, bf16): qwen2-moe FFN-split (``wo``, the experts' gated
    partial sum and the shared experts' ``down``, a ``[t, d]`` float32
    all-reduce each), arctic expert-parallel (``wo`` and the dense
    residual's ``down``; the all-to-all each way of the line's mean
    ``[t x 2 / 2, d]``, the all-gather of ``[2 x ceil(t / 2), d]``, in
    bf16)."""
    layers, d, a, f, k = 2, 64, 2, 4, 2
    t = 32 // 2 * 32768 if kind == "prefill" else 128 // 2
    ar, emb = t * d * f, t * d * a
    flat_ag, a2a = 0, 0
    if layout == "ffn":
        flat_ar = 3 * ar
    else:
        flat_ar = 2 * ar
        a2a = t * 2 * d * a // k
        flat_ag = k * -(-t // k) * d * a
    ag_count = 0 if layout == "ffn" else 1
    if kind == "decode":
        # the sequence-split cache's attention terms (4 heads, 4 or 2 KV
        # heads of 16)
        kv = 4 if layout == "ffn" else 2
        flat_ag += t * (4 + 2 * kv) * 16 * a
        ag_count += 1
        flat_ar += 2 * t * 4 * 4 + t * 4 * 16 * f
    n_ar = (3 if layout == "ffn" else 2) + (3 if kind == "decode" else 0)
    flat = _tally(all_reduce=(flat_ar + emb, n_ar + 1),
                  all_gather=(flat_ag, ag_count),
                  all_to_all=(2 * a2a, 2 if a2a else 0))
    executed = _tally(all_reduce=(layers * flat_ar + emb,
                                  layers * n_ar + 1),
                      all_gather=(layers * flat_ag, layers * ag_count),
                      all_to_all=(layers * 2 * a2a,
                                  layers * 2 if a2a else 0))
    return flat, executed


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch,layout", [("qwen2-moe-a2.7b", "ffn"),
                                         ("arctic-480b", "model")])
def test_moe_collectives_equal_the_hand_count(arch, layout, kind):
    over = dict(_overrides(arch), expert_sharding=layout)
    rec = dryrun.lower_cell(arch, f"{kind}_32k", mesh_shape=(2, 2),
                            overrides=over, device="cpu")
    flat, executed = _moe_hand_counted(layout, kind)
    assert rec["collective"] == flat
    assert rec["collective_executed"] == executed


@pytest.mark.parametrize("layout", ["ffn", "model"])
def test_moe_train_terms_count_what_the_backward_runs(layout):
    """A MoE train cell on (1, 4) (qwen2-moe's smoke model: ``k`` = 4, d
    64, top 2, bf16, remat "full", t = 8 x 64 tokens), by hand: the
    experts' forward terms in the forward and the remat recompute only;
    the backward adds, FFN-split, the tokens' and gates' entry sum (one
    float32 ``[t, d + 2]`` panel and its status word) and,
    expert-parallel, the two reverse all-to-alls and the float32
    all-gather of the rank rows' token and gate gradients ``[k x
    ceil(t / k), d + 2]``."""
    over = dict(_overrides("qwen2-moe-a2.7b"), expert_sharding=layout)
    rec = dryrun.lower_cell("qwen2-moe-a2.7b", SMALL["train"],
                            mesh_shape=(1, 4), overrides=over, device="cpu")
    layers, d, a, f, k, top = 2, 64, 2, 4, 4, 2
    t = 8 * 64
    ar = 2 * t * d * f + (t * d + 1) * f      # a row-split dense's three
    head = t * d * a + 3 * t * 4 + (t * d + 1) * f
    body, n_ar = 2 * ar, 6                    # attention's wo, shared down
    a2a = ag = n_a2a = n_ag = 0
    if layout == "ffn":
        body += 2 * t * d * f + (t * (d + top) + 1) * f
        n_ar += 3
    else:
        rows = k * -(-t // k)
        a2a, n_a2a = 3 * 2 * (t * top * d * a // k), 6
        ag, n_ag = 2 * rows * d * a + rows * (d + top) * f, 3
    executed = _tally(all_reduce=(layers * body + head + 4,
                                  layers * n_ar + 5 + 1),
                      all_gather=(layers * ag, layers * n_ag),
                      all_to_all=(layers * a2a, layers * n_a2a))
    assert rec["collective_executed"] == executed


def test_collectives_vanish_without_a_split_axis():
    """One device in every axis: nothing to move."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.lower_cell("qwen3-1.7b", shape, mesh_shape=(1, 1),
                                overrides=_overrides("qwen3-1.7b"),
                                device="cpu")
        assert rec["collective_executed"]["total_bytes"] == 0
        assert rec["collective"]["total_bytes"] == 0


def test_microbatches_and_layers_multiply_the_executed_count():
    """The same cell at 4 microbatches: per-microbatch terms shrink 4x
    (a quarter of the tokens each) and run 4 times, but for the status
    word beside each backward sum (one a row-split dense and the head's,
    4 bytes whatever the tokens); the gradient reduction and the step's
    three terms (the qk norms' gradients, the norm, the loss) run
    once."""
    over = dict(_overrides("qwen3-1.7b"), microbatch=4)
    one = dryrun.lower_cell("qwen3-1.7b", "train_4k", mesh_shape=(2, 2),
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu")
    four = dryrun.lower_cell("qwen3-1.7b", "train_4k", mesh_shape=(2, 2),
                             overrides=over, device="cpu")
    for kind in ("all-gather", "reduce-scatter"):
        assert four["collective_executed"]["bytes"][kind] == \
            one["collective_executed"]["bytes"][kind]
    layers, status = 2, 4
    flat_status = (2 + 1) * status            # one layer and the head
    executed_status = (2 * layers + 1) * status
    step = 2 * layers * 16 * 4 + 4 + 4        # qk norms; norm; loss
    ar1 = one["collective_executed"]["bytes"]["all-reduce"]
    ar4 = four["collective_executed"]["bytes"]["all-reduce"]
    assert ar4 - 4 * executed_status == ar1 - executed_status
    assert four["collective_executed"]["counts"]["all-reduce"] - 3 == \
        4 * (one["collective_executed"]["counts"]["all-reduce"] - 3)
    assert (four["collective"]["bytes"]["all-reduce"] - flat_status
            - step) * 4 == \
        one["collective"]["bytes"]["all-reduce"] - flat_status - step


def test_full_size_cells_price_without_allocating():
    """Every cell of both production meshes at the full configs on the
    CPU, on ``meta`` records: 64 priced, 16 skipped."""
    recs = dryrun.main(["--all", "--both-meshes", "--device", "cpu"])
    status = [r["status"] for r in recs]
    assert status.count("ok") == 64 and status.count("skipped") == 16
    for r in recs:
        if r["status"] == "ok":
            assert r["memory"]["argument_bytes"] > 0, r["arch"]
            assert r["collective_executed"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# the run path, on the CPU at smoke widths on reduced cells
# ---------------------------------------------------------------------------

SMALL = {"train": ShapeCell("train_4k", 64, 8, "train"),
         "prefill": ShapeCell("prefill_32k", 64, 4, "prefill"),
         "decode": ShapeCell("decode_32k", 64, 8, "decode")}
RUN_FAMILIES = FAMILIES + ("arctic-480b",)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", RUN_FAMILIES)
def test_run_on_the_cpu_adds_its_fields_and_checks(arch, kind):
    rec = dryrun.lower_cell(arch, SMALL[kind], mesh_shape=(4, 1),
                            overrides=_overrides(arch), device="cpu",
                            run=True)
    assert rec["status"] == "ok" and "run_reason" not in rec
    assert set(RUN_FIELDS) <= set(rec)
    assert rec["run_batch"] == SMALL[kind].global_batch // 4
    # nothing on the CPU is a device measurement
    assert rec["run_s"] is None and rec["peak_bytes"] is None
    assert rec["run_times_s"] is None
    assert rec["run_flops"] > 0 and rec["run_bound_s"] > 0
    checks = rec["run_checks"]
    if kind == "train":
        n = len(list(dryrun.build_model(
            dataclasses.replace(get_config(arch), **_overrides(arch)),
            device="meta").parameters()))
        assert checks[-1] == f"all {n} parameters changed"
    elif kind == "prefill":
        assert checks[0] == f"logits [{rec['run_batch']}, 256]"
    elif get_smoke_config(arch).family != "ssm":
        assert "k/v written at pos 63 only" in checks


def test_long_context_decode_runs_the_whole_batch():
    rec = dryrun.lower_cell("falcon-mamba-7b",
                            ShapeCell("long_500k", 96, 1, "decode"),
                            mesh_shape=(4, 1),
                            overrides=_overrides("falcon-mamba-7b"),
                            device="cpu", run=True)
    assert rec["run_batch"] == 1 and rec["run_flops"] > 0


def test_decode_that_writes_away_from_pos_fails(monkeypatch):
    make = dryrun.make_serve_step

    def wrong(model, cfg):
        step = make(model, cfg)

        def serve_step(cache, tokens, pos):
            logits, cache = step(cache, tokens, pos)
            cache["k"][:, :, 0] += 1          # a write at slot 0 as well
            return logits, cache
        return serve_step
    monkeypatch.setattr(dryrun, "make_serve_step", wrong)
    with pytest.raises(AssertionError, match="changed away from pos"):
        dryrun.lower_cell("qwen3-1.7b", SMALL["decode"], mesh_shape=(4, 1),
                          overrides=_overrides("qwen3-1.7b"), device="cpu",
                          run=True)


def test_train_that_leaves_a_parameter_fails(monkeypatch):
    make = dryrun.make_train_step

    def frozen(model, cfg, opt_cfg):
        step = make(model, cfg, opt_cfg)
        keep = model.ln_f.scale.detach().clone()

        def train_step(params, state, batch):
            out = step(params, state, batch)
            with torch.no_grad():
                model.ln_f.scale.copy_(keep)
            return out
        return train_step
    monkeypatch.setattr(dryrun, "make_train_step", frozen)
    with pytest.raises(AssertionError, match="ln_f.scale did not change"):
        dryrun.lower_cell("qwen3-1.7b", SMALL["train"], mesh_shape=(4, 1),
                          overrides=_overrides("qwen3-1.7b"), device="cpu",
                          run=True)


@pytest.mark.parametrize("mesh_shape,multi_pod", [
    (None, False), (None, True), ((2, 2), False)])
def test_a_cell_with_a_split_model_or_pod_axis_runs_nothing(mesh_shape,
                                                             multi_pod):
    """Without ranks a split ``model`` axis runs nothing."""
    rec = dryrun.lower_cell("qwen3-1.7b", SMALL["decode"],
                            multi_pod=multi_pod, mesh_shape=mesh_shape,
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu", run=True)
    assert "tensor-parallel share runs on ranks only" in rec["run_reason"]
    assert not set(RUN_FIELDS) & set(rec)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_a_pod_axis_only_splits_the_batch(kind):
    """A (pod, data, model) = (2, 4, 1) cell runs one device's share in
    one process: its batch is ``global_batch / (pod x data)``, rounded
    up (8 / 8 for decode, 4 / 8 for prefill)."""
    rec = dryrun.lower_cell("qwen3-1.7b", SMALL[kind], mesh_shape=(2, 4, 1),
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu", run=True)
    assert "run_reason" not in rec and set(RUN_FIELDS) <= set(rec)
    assert rec["run_batch"] == 1
    if kind == "prefill":
        assert rec["run_checks"] == [f"logits [{rec['run_batch']}, 256]",
                                     "logits finite"]
    else:
        assert rec["run_checks"] == ["logits finite", "cache finite",
                                     "k/v written at pos 63 only"]


class _Ranks:
    """The ``ProcessMesh`` fields ``_run_rule`` and ``block_slices`` read,
    without a process group."""

    def __init__(self, shape, coords=None):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = coords or (0, 0)

    def axis_index(self, axis):
        return self.coords[self.axis_names.index(axis)]


_SMOKE = get_smoke_config("qwen3-1.7b")


@pytest.mark.parametrize("case", [
    # the production 16 x 16 mesh on four ranks
    (None, (1, 4), _SMOKE, "decode", "model axis 4 differs from the "
                                     "cell's 16"),
    ((8, 4), (1, 4), _SMOKE, "decode", "does not divide n_kv_heads 2"),
    ((8, 4), (1, 4), dataclasses.replace(_SMOKE, n_kv_heads=4, d_ff=126),
     "prefill", "does not divide d_ff 126"),
    ((8, 4), (1, 4), dataclasses.replace(_SMOKE, n_kv_heads=4, vocab=250),
     "prefill", "does not divide vocab 250"),
    ((8, 2), (2, 2), _SMOKE, "train",
     "the ranks' data axis 2 is below the cell's 8 batch blocks"),
    ((8, 2), (2, 2), dataclasses.replace(
        get_smoke_config("qwen2-moe-a2.7b"), moe_capacity=True), "decode",
     "capacity dispatch (moe_capacity) on ranks"),
    ((1, 2), (2, 2), _SMOKE, "decode", "data axis 2 exceeds the cell's 1"),
    ((8, 4), (1, 4), dataclasses.replace(_SMOKE, n_kv_heads=4), "decode62",
     "does not divide seq_len 62"),
    ((8, 2), (2, 2), dataclasses.replace(
        get_smoke_config("arctic-480b"), expert_sharding="model+data"),
     "prefill", "expert_sharding 'model+data' with the ranks' data axis 2"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("arctic-480b"), expert_sharding="model",
        n_kv_heads=4, n_experts=6), "decode", "does not divide n_experts 6"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("qwen2-moe-a2.7b"), moe_d_ff=66), "prefill",
     "does not divide moe_d_ff 66"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("qwen2-moe-a2.7b"), expert_sharding="model",
        moe_d_ff=66), "prefill",
     "does not divide n_shared_experts x moe_d_ff 66"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("arctic-480b"), expert_sharding="model",
        n_kv_heads=4, d_ff=98), "prefill", "does not divide d_ff 98"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("llava-next-mistral-7b"), n_kv_heads=4,
        d_model=66), "prefill", "does not divide d_model 66"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("falcon-mamba-7b"), d_model=65), "decode",
     "does not divide d_inner 130"),
    ((8, 4), (1, 4), get_config("recurrentgemma-2b"), "decode",
     "does not divide n_heads 10"),
    ((8, 2), (2, 2), dataclasses.replace(
        get_smoke_config("recurrentgemma-2b"), n_heads=12, n_kv_heads=3),
     "prefill", "would straddle KV groups"),
    ((8, 4), (1, 4), dataclasses.replace(
        get_smoke_config("whisper-large-v3"), d_model=66), "prefill",
     "does not divide d_model 66"),
    ((8, 4), (1, 4), get_smoke_config("whisper-large-v3"), "decode62",
     "does not divide seq_len 62"),
    ((1, 4), (1, 4), get_smoke_config("falcon-mamba-7b"), "long",
     "a long-context decode"),
    ((1, 4), (1, 4), get_smoke_config("recurrentgemma-2b"), "train",
     "training a 'hybrid' model on ranks"),
    ((1, 4), (1, 4), get_smoke_config("falcon-mamba-7b"), "train",
     "training a 'ssm' model on ranks"),
    ((8, 4), (1, 4), dataclasses.replace(_SMOKE, n_kv_heads=4), "train",
     "the ranks' data axis 1 is below the cell's 8 batch blocks"),
    ((1, 4), (1, 4), dataclasses.replace(_SMOKE, n_kv_heads=4,
                                         opt_8bit=True), "train",
     "8-bit Adam moments on ranks"),
], ids=["production-mesh", "kv-heads", "d_ff", "vocab", "train", "moe",
        "data-rows", "seq_len", "model+data-on-data-2", "n_experts",
        "moe_d_ff", "shared-experts", "dense-residual", "projector", "ssm",
        "hybrid-heads", "hybrid-kv-groups", "encdec-d_model",
        "encdec-seq_len", "long-context", "train-moe", "train-ssm",
        "train-cell-data", "train-8bit"])
def test_the_run_rule_says_why_a_cell_cannot_run_on_ranks(case):
    mesh_shape, ranks, cfg, kind, why = case
    mesh = (dryrun.make_production_mesh(device="cpu") if mesh_shape is None
            else dryrun.make_mesh(mesh_shape, ("data", "model"),
                                  device="cpu"))
    shape = (ShapeCell("decode_32k", 62, 8, "decode") if kind == "decode62"
             else ShapeCell("long_500k", 64, 1, "decode") if kind == "long"
             else SMALL[kind])
    assert why in dryrun._run_rule(mesh, cfg, shape, _Ranks(ranks))


def test_training_on_ranks_names_the_item_that_ports_it():
    """A data axis over 1 runs (the gradient reduction and ZeRO-1 over
    data, 5b-2, are ported), and so does the MoE and VLM families'
    training (their backwards, 5b-3a); the Mamba, hybrid and Whisper
    families' training names the item of theirs (5b-3b)."""
    mesh = dryrun.make_mesh((2, 2), ("data", "model"), device="cpu")
    assert dryrun._run_rule(mesh, _SMOKE, SMALL["train"],
                            _Ranks((2, 2))) is None
    line = dryrun.make_mesh((1, 4), ("data", "model"), device="cpu")
    for arch, over in (("qwen2-moe-a2.7b", {}),
                       ("qwen2-moe-a2.7b", {"expert_sharding": "model"}),
                       ("llava-next-mistral-7b", {"n_kv_heads": 4})):
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        assert dryrun._run_rule(line, cfg, SMALL["train"],
                                _Ranks((1, 4))) is None, (arch, over)
    assert dryrun._run_rule(mesh, get_smoke_config("qwen2-moe-a2.7b"),
                            SMALL["train"], _Ranks((2, 2))) is None
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b",
                 "whisper-large-v3"):
        assert "(ROADMAP.md, A10d-5b-3b)" in dryrun._run_rule(
            line, get_smoke_config(arch), SMALL["train"], _Ranks((1, 4)))


def test_the_run_rule_takes_a_dense_train_cell_on_a_2x2_grid():
    """A dense train cell whose batch blocks are the ranks' data axis
    runs on a 2 x 2 grid, with ZeRO-1 and without, and on a (2, 1) grid
    that splits the batch alone; the same cell on a mesh with more batch
    blocks than the ranks' data axis does not."""
    grid = dryrun.make_mesh((2, 2), ("data", "model"), device="cpu")
    for cfg in (_SMOKE, dataclasses.replace(_SMOKE, zero1=False)):
        assert dryrun._run_rule(grid, cfg, SMALL["train"],
                                _Ranks((2, 2))) is None
    rows = dryrun.make_mesh((2, 1), ("data", "model"), device="cpu")
    assert dryrun._run_rule(rows, _SMOKE, SMALL["train"],
                            _Ranks((2, 1))) is None
    wide = dryrun.make_mesh((4, 2), ("data", "model"), device="cpu")
    assert "is below the cell's 4 batch blocks" in dryrun._run_rule(
        wide, _SMOKE, SMALL["train"], _Ranks((2, 2)))


@pytest.mark.parametrize("case", [
    ((2, 2, 2), ("pod", "data", "model"), _SMOKE,
     "a pod axis: the gradient's all-reduce over pod"),
    ((2, 2), ("data", "model"), dataclasses.replace(_SMOKE, microbatch=8),
     "a microbatch of 8 / 8 rows does not split over the data axis of 2"),
    ((2, 2), ("data", "model"), dataclasses.replace(_SMOKE, opt_8bit=True),
     "8-bit Adam moments on ranks"),
    ((2, 2), ("data", "model"), get_smoke_config("falcon-mamba-7b"),
     "(ROADMAP.md, A10d-5b-3b)")],
    ids=["pod", "microbatch", "8bit", "moe"])
def test_the_run_rule_refuses_a_2x2_train_cell_it_cannot_split(case):
    """On a 2 x 2 grid a train cell still records why it cannot run: a
    ``pod`` axis, microbatches whose rows do not split over ``data``,
    8-bit moments, a family whose backwards are not ported (the ids
    ``train-moe`` / ``moe`` of the two refusal tests hold such a family
    since the MoE family trains on ranks)."""
    mesh_shape, axes, cfg, why = case
    mesh = dryrun.make_mesh(mesh_shape, axes, device="cpu")
    assert why in dryrun._run_rule(mesh, cfg, SMALL["train"],
                                   _Ranks((2, 2)))


def test_the_run_rule_takes_a_dense_train_cell_on_one_model_line():
    """A dense train cell whose batch is not split, on ranks whose model
    axis is the cell's, runs; the same cell on a split batch does not."""
    kv4 = dataclasses.replace(_SMOKE, n_kv_heads=4)
    line = dryrun.make_mesh((1, 4), ("data", "model"), device="cpu")
    assert dryrun._run_rule(line, kv4, SMALL["train"], _Ranks((1, 4))) \
        is None
    assert "does not divide n_kv_heads 2" in dryrun._run_rule(
        line, _SMOKE, SMALL["train"], _Ranks((1, 4)))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (4, 1), (1, 4)])
def test_the_train_step_terms_appear_only_where_model_is_split(mesh_shape):
    """A train cell's two step terms over ``model``: one float32
    all-reduce of the qk norms' partial gradients (``2 L hd`` values; none
    without ``qk_norm``) and one of the global norm's single value,
    where ``model`` is split (``(1, 4)``: a layer's six row-split sums,
    the embedding's, the loss's three statistics and the head's input
    gradient besides); on a ``model`` axis of 1 neither over ``model``
    (``(4, 1)``: the gradient reduction over ``data`` reduce-scatters
    every leaf, so the norm's value and the loss's cross ``data``, 4
    bytes each; ``(1, 1)``: nothing)."""
    def all_reduces(qk_norm):
        over = dict(_overrides("qwen3-1.7b"), n_kv_heads=4, qk_norm=qk_norm)
        rec = dryrun.lower_cell("qwen3-1.7b", SMALL["train"],
                                mesh_shape=mesh_shape, overrides=over,
                                device="cpu")
        got = rec["collective_executed"]
        return got["counts"]["all-reduce"], got["bytes"]["all-reduce"]
    (with_qk, with_bytes), (without, without_bytes) = (all_reduces(True),
                                                        all_reduces(False))
    layers, hd = _SMOKE.n_layers, _SMOKE.hd
    if mesh_shape[1] == 1:
        over_data = 2 if mesh_shape[0] > 1 else 0
        assert with_qk == without == over_data
        assert with_bytes == without_bytes == 4 * over_data
        return
    assert without == 6 * layers + 1 + 3 + 1 + 1
    assert with_qk == without + 1
    assert with_bytes - without_bytes == 2 * layers * hd * 4


def test_the_run_rule_takes_a_dense_split_cell_on_matching_ranks():
    mesh = dryrun.make_mesh((8, 2), ("data", "model"), device="cpu")
    for kind in ("prefill", "decode"):
        assert dryrun._run_rule(mesh, _SMOKE, SMALL[kind],
                                _Ranks((2, 2))) is None
        assert "on ranks only" in dryrun._run_rule(mesh, _SMOKE,
                                                   SMALL[kind])


@pytest.mark.parametrize("arch,over,ranks", [
    ("qwen2-moe-a2.7b", {}, (2, 2)),
    ("arctic-480b", {"expert_sharding": "model+data"}, (1, 2)),
    ("arctic-480b", {"expert_sharding": "model"}, (2, 2)),
    ("llava-next-mistral-7b", {}, (2, 2))],
    ids=["ffn", "model+data", "model", "vlm"])
def test_the_run_rule_takes_moe_and_vlm_split_cells(arch, over, ranks):
    """FFN-split and expert-parallel experts (``"model+data"`` on ranks
    whose data axis is 1) and LLaVA split exactly on two-wide ``model``
    lines."""
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    mesh = dryrun.make_mesh((8, 2), ("data", "model"), device="cpu")
    for kind in ("prefill", "decode"):
        assert dryrun._run_rule(mesh, cfg, SMALL[kind],
                                _Ranks(ranks)) is None


@pytest.mark.parametrize("arch,over,ranks", [
    ("falcon-mamba-7b", {}, (1, 4)),
    ("recurrentgemma-2b", {}, (2, 2)),
    ("recurrentgemma-2b", {}, (1, 4)),
    ("whisper-large-v3", {}, (1, 4))],
    ids=["ssm", "hybrid-2", "hybrid-4", "encdec"])
def test_the_run_rule_takes_the_state_and_encoder_decoder_families(
        arch, over, ranks):
    """Mamba, the hybrid (one KV head, fewer than the axis: gathered) and
    Whisper split exactly on their smoke widths."""
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    mesh = dryrun.make_mesh((8, ranks[1]), ("data", "model"), device="cpu")
    for kind in ("prefill", "decode"):
        assert dryrun._run_rule(mesh, cfg, SMALL[kind],
                                _Ranks(ranks)) is None


def _hybrid_hand_counted(kind):
    """The hybrid's terms on its 6-layer smoke model (two (rec, rec, attn)
    groups, no tail; d 64, d_rnn 64, one KV head of 16, bf16) on 2 x 2:
    a group's two rec ``out``, three MLP ``down`` and ``wo``, a ``[t,
    64]`` float32 all-reduce each; the conv output ``[t, 64]`` gathered
    a rec block and the new k and v ``[t, 2 x 16]`` once (one KV head on
    a model axis of 2, and in decode the window), in bf16; the
    embedding's all-reduce; the tied head's logits stay vocab-split."""
    groups, d, a, f = 2, 64, 2, 4
    t = 32 // 2 * 32768 if kind == "prefill" else 128 // 2
    ar, emb = 6 * t * d * f, t * d * a
    ag = 2 * t * 64 * a + t * 2 * 16 * a
    return (_tally(all_reduce=(ar + emb, 7), all_gather=(ag, 3)),
            _tally(all_reduce=(groups * ar + emb, groups * 6 + 1),
                   all_gather=(groups * ag, groups * 3)))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_hybrid_collectives_equal_the_hand_count(kind):
    rec = dryrun.lower_cell("recurrentgemma-2b", f"{kind}_32k",
                            mesh_shape=(2, 2),
                            overrides=_overrides("recurrentgemma-2b"),
                            device="cpu")
    flat, executed = _hybrid_hand_counted(kind)
    assert rec["collective"] == flat
    assert rec["collective_executed"] == executed


@pytest.mark.parametrize("model,gathered", [(2, False), (4, True)])
def test_the_kv_gather_is_counted_where_the_axis_splits_no_kv_head(
        model, gathered):
    """``qwen3-1.7b``'s SMOKE model (2 layers, 2 KV heads of 16, bf16): a
    model axis of 4 cuts inside a KV head, so each layer's prefill
    gathers the new k and v ``[t, 2 x 2 x 16]`` (``layers.gathers_kv``,
    whatever the family); an axis of 2 splits the heads and gathers
    nothing."""
    from repro_torch.models.layers import gathers_kv
    assert gathers_kv(get_smoke_config("qwen3-1.7b"), model,
                      False) is gathered
    rec = dryrun.lower_cell("qwen3-1.7b", "prefill_32k",
                            mesh_shape=(2, model),
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu")
    got = rec["collective_executed"]
    t = 32 // 2 * 32768
    assert got["counts"]["all-gather"] == (2 if gathered else 0)
    assert got["bytes"]["all-gather"] == (
        2 * t * 2 * 2 * 16 * 2 if gathered else 0)


def test_whisper_head_all_reduces_its_logits_in_token_pieces():
    """Whisper's tied head contracts over the split ``d_model``: its
    ``[t, V]`` float32 logits cross in ``HEAD_CHUNK_TOKENS``-token
    all-reduces (4,096 tokens: 16 of 256), the same bytes as one."""
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import whisper
    cfg = get_config("whisper-large-v3")
    cell = dataclasses.replace(SHAPES["prefill_32k"], seq_len=4096)
    rec = dryrun.lower_cell("whisper-large-v3", cell, mesh_shape=(32, 4),
                            overrides={"n_layers": 4, "enc_layers": 4},
                            device="cpu")
    got = rec["collective_executed"]
    assert whisper.HEAD_CHUNK_TOKENS == 256
    # encoder 4 x (wo, fc2), decoder 4 x (wo twice, fc2), head 16 pieces
    assert got["counts"]["all-reduce"] == 8 + 12 + 16
    assert got["counts"]["all-gather"] == 1
    d, t = cfg.d_model, 4096
    layers = (8 * 1500 + 12 * t) * d * 4
    assert got["bytes"]["all-reduce"] == layers + t * cfg.vocab * 4
    assert got["bytes"]["all-gather"] == t * d * 2


def test_a_cell_the_ranks_cannot_split_records_why_and_runs_nothing():
    rec = dryrun.lower_cell("qwen3-1.7b", SMALL["decode"],
                            mesh_shape=(8, 4),
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu", run=True, ranks=_Ranks((1, 4)))
    assert "n_kv_heads 2" in rec["run_reason"]
    assert not set(RUN_FIELDS) & set(rec)


@pytest.mark.parametrize("coords,want", [
    ((0, 0), [(0, 4), (0, 3), (0, 6)]), ((0, 1), [(0, 4), (3, 6), (0, 6)]),
    ((1, 1), [(4, 7), (3, 6), (0, 6)])])
def test_a_rank_block_takes_ceil_d_over_k_entries(coords, want):
    """[7, 6, 6] split ("data", "model", None) on a 2 x 2 grid: 7 rows
    in blocks of 4 (the last holds 3), 6 columns in blocks of 3."""
    from repro_torch.distributed_lm.sharding import block_slices, leaf_block
    from repro_torch.models.layers import P
    ranks = _Ranks((2, 2), coords)
    got = block_slices((7, 6, 6), P("data", "model"), ranks)
    assert [(s.start, s.stop) for s in got] == want
    t = torch.arange(7 * 6 * 6).reshape(7, 6, 6)
    assert torch.equal(leaf_block(t, P("data", "model"), ranks),
                       t[want[0][0]:want[0][1], want[1][0]:want[1][1]])


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_an_entry_of_two_axes_splits_row_major(coords):
    """``("data", "model")`` over 2 x 2: four blocks, the data coordinate
    major (the reference's device order)."""
    from repro_torch.distributed_lm.sharding import block_slices
    from repro_torch.models.layers import P
    got = block_slices((8, 3), P(("data", "model")), _Ranks((2, 2), coords))
    c = 2 * coords[0] + coords[1]
    assert (got[0].start, got[0].stop) == (2 * c, 2 * c + 2)
    assert (got[1].start, got[1].stop) == (0, 3)


def test_leaf_spec_drops_the_layer_axis_of_a_stacked_group():
    from repro_torch.distributed_lm.sharding import leaf_spec
    model = dryrun.build_model(_SMOKE, device="meta")
    specs = model.param_specs()
    assert tuple(leaf_spec(specs, "blocks.1.attn.wo.w")) == ("model", None)
    assert tuple(leaf_spec(specs, "blocks.0.mlp.gate.w")) == (None, "model")
    assert tuple(leaf_spec(specs, "embed")) == ("model", None)
    assert tuple(leaf_spec(specs, "lm_head.w")) == (None, "model")
    assert tuple(leaf_spec(specs, "blocks.0.ln1.scale")) == (None,)


@pytest.mark.parametrize("layout,w_gate,w_down,blocks", [
    ("ffn", (None, None, "model"), (None, "model", None),
     [(8, 64, 32), (8, 32, 64)]),
    ("model", ("model", None, None), ("model", None, None),
     [(4, 64, 64), (4, 64, 64)]),
    ("model+data", ("model", None, "data"), ("model", "data", None),
     [(4, 64, 64), (4, 64, 64)])])
def test_expert_and_projector_leaves_take_their_rank_blocks(layout, w_gate,
                                                           w_down, blocks):
    """The 3-D expert leaves and LLaVA's projector under ``leaf_spec``
    and ``block_slices`` on a (data, model) = (1, 2) rank: FFN-split
    experts keep every expert and half its hidden units, experts over
    ``model`` (and over ``model`` and a ``data`` axis of 1) half the
    experts whole."""
    from repro_torch.distributed_lm.sharding import block_slices, leaf_spec
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              expert_sharding=layout)
    specs = dryrun.build_model(cfg, device="meta").param_specs()
    assert tuple(leaf_spec(specs, "blocks.1.moe.w_gate")) == w_gate
    assert tuple(leaf_spec(specs, "blocks.0.moe.w_down")) == w_down
    assert tuple(leaf_spec(specs, "blocks.0.moe.router.w")) == (None, None)
    assert tuple(leaf_spec(specs, "blocks.0.moe.shared.down.w")) == \
        ("model", None)
    rank = _Ranks((1, 2), coords=(0, 1))
    for key, shape, want in (("blocks.0.moe.w_gate", (8, 64, 64), blocks[0]),
                             ("blocks.0.moe.w_down", (8, 64, 64), blocks[1])):
        got = block_slices(shape, leaf_spec(specs, key), rank)
        assert tuple(s.stop - s.start for s in got) == want, key
    vlm = dryrun.build_model(get_smoke_config("llava-next-mistral-7b"),
                             device="meta").param_specs()
    assert tuple(leaf_spec(vlm, "vision_proj.fc1.w")) == (None, "model")
    assert tuple(leaf_spec(vlm, "vision_proj.fc1.b")) == ("model",)
    assert tuple(leaf_spec(vlm, "vision_proj.fc2.w")) == ("model", None)
    assert tuple(leaf_spec(vlm, "vision_proj.fc2.b")) == (None,)


def test_no_device_means_cuda_and_raises_without_one(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.lower_cell("qwen3-1.7b", SMALL["decode"], mesh_shape=(4, 1),
                          overrides=_overrides("qwen3-1.7b"), run=True)
    with pytest.raises(SystemExit, match="1 cell"):
        dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                     "--mesh-shape", "128,1", "--run"])
    assert "RuntimeError: no CUDA device" in capsys.readouterr().out


def test_keep_hlo_is_accepted_and_adds_nothing():
    rec = dryrun.lower_cell("qwen3-1.7b", "decode_32k", keep_hlo=True,
                            overrides=_overrides("qwen3-1.7b"),
                            device="cpu")
    assert "hlo_len" not in rec and "_hlo" not in rec
