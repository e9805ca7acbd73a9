"""The port's docs check (``repro_torch.tools.check_docs``) and the
reference's (``tools/check_docs.py``) both pass on this tree, and the
port's fails when ``docs/ARCHITECTURE_TORCH.md`` loses a row of any
registry it is held to."""
import importlib.util
import pathlib
import shutil

import pytest

from repro_torch.tools import check_docs

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = ROOT / "docs" / "ARCHITECTURE_TORCH.md"


def _reference_check():
    spec = importlib.util.spec_from_file_location(
        "reference_check_docs", ROOT / "tools" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_docs_check_passes(capsys):
    assert check_docs.problems() == []
    assert check_docs.main() == 0
    assert "docs OK" in capsys.readouterr().out


def test_reference_docs_check_passes_and_reads_the_new_file(capsys):
    ref = _reference_check()
    assert ARCH in ref.doc_files()
    assert ref.main() == 0
    assert "docs OK" in capsys.readouterr().out


def _without(tmp_path, starts):
    lines = [ln for ln in ARCH.read_text().splitlines(keepends=True)
             if not ln.startswith(starts)]
    out = tmp_path / ARCH.name
    out.write_text("".join(lines))
    return out


@pytest.mark.parametrize("row,expect", [
    ("| `threshold` |", "backend table is missing registered backend "
                        "`threshold`"),
    ("| `closure` | rebuild", "update-capability table is missing "
                              "registered backend `closure`"),
    ("| `MRRequest` |", "request-type table is missing `mr`"),
    ("| `sharded` | `build_sharded`", "construction-mode table is missing "
                                      "`sharded`"),
    ("| `1` | `aligned-segments-v1`", "format-version table is missing `1`"),
    ("| `label_join` | `label_join_ref`", "kernel table is missing "
                                          "`label_join`"),
    ("| `interactive` | 0", "priority-class table is missing `interactive`"),
    ("| `deadline_ms` |", "request-field table is missing `deadline_ms`"),
    ("| `ete` | yes | no", "workload-capability table is missing `ete`"),
    ("| `maxmin__sp__ring__float32` |", "dry-run cell table is missing "
                                        "`maxmin__sp__ring__float32`"),
    ("| `qwen2-moe-a2.7b` | `moe`", "model-family table is missing "
                                   "`qwen2-moe-a2.7b`"),
    ("| `whisper-large-v3` | `encdec`", "model-family table is missing "
                                       "`whisper-large-v3`"),
])
def test_a_missing_registry_row_fails(tmp_path, row, expect):
    found = check_docs.problems(arch=_without(tmp_path, row))
    assert any(expect in p for p in found), found


def test_a_wrong_kernel_unit_fails(tmp_path):
    arch = tmp_path / ARCH.name
    arch.write_text(ARCH.read_text().replace(
        "| `overlap` | `overlap_ref` | tensor cores |",
        "| `overlap` | `overlap_ref` | CUDA cores |"))
    found = check_docs.problems(arch=arch)
    assert any("kernel table documents `overlap`" in p for p in found), found


def test_a_family_marked_ported_that_is_not_fails(tmp_path):
    """A row whose status or model disagrees with the registry fails
    (every family is ported now, so the status is flipped the other
    way)."""
    for old, new in (("| `falcon-mamba-7b` | `ssm` | `MambaLM` | ported |",
                      "| `falcon-mamba-7b` | `ssm` | `MambaLM` | not ported |"),
                     ("| `recurrentgemma-2b` | `hybrid` | `GriffinLM` |",
                      "| `recurrentgemma-2b` | `hybrid` | `MambaLM` |")):
        arch = tmp_path / ARCH.name
        text = ARCH.read_text()
        assert old in text
        arch.write_text(text.replace(old, new))
        found = check_docs.problems(arch=arch)
        name = old.split("`")[1]
        assert any(f"model-family table documents `{name}`" in p
                   for p in found), found


@pytest.mark.parametrize("name", ["launch/hlo_analysis.py", "compat.py"])
def test_the_modules_without_counterpart_stay_named(tmp_path, name):
    arch = tmp_path / ARCH.name
    arch.write_text(ARCH.read_text().replace(f"`{name}`", name))
    found = check_docs.problems(arch=arch)
    assert any(f"does not name `{name}`" in p for p in found), found


def test_a_broken_link_fails(tmp_path):
    (tmp_path / "docs").mkdir()
    (tmp_path / "README.md").write_text("[ok](docs/a.md)\n")
    (tmp_path / "docs" / "a.md").write_text("[gone](../no_such_file.py)\n")
    found = check_docs.check_links(tmp_path)
    assert found == ["docs/a.md: broken link -> ../no_such_file.py"]


# the measurement log and the change log are kept beside the code, not
# shipped with it: a checkout of the program alone must pass check 1 too
KEPT_BESIDE_THE_CODE = ("PERF.md", "CHANGES.md", "ISSUE.md")


def test_links_resolve_without_the_documents_kept_beside_the_code(tmp_path):
    for entry in ROOT.iterdir():
        if entry.name in KEPT_BESIDE_THE_CODE or entry.name == ".git":
            continue
        if entry.name == "docs":
            # a copy, not a link: "../x" from a linked directory would
            # resolve against the real tree
            shutil.copytree(entry, tmp_path / "docs")
        else:
            (tmp_path / entry.name).symlink_to(entry)
    assert check_docs.check_links(tmp_path) == []


def test_a_missing_file_fails(tmp_path):
    found = check_docs.problems(arch=tmp_path / "NOPE.md")
    assert found == ["NOPE.md is missing"]
