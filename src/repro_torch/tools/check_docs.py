"""Docs consistency guard of the port: the reference's nine checks
(``tools/check_docs.py``), and one of its own, against ``repro_torch``'s
live registries and
``docs/ARCHITECTURE_TORCH.md``, so the port's documentation cannot
silently drift from its code:

1. Every relative markdown link in README.md and docs/*.md resolves to
   an existing file or directory.
2. Every backend name in ``repro_torch.api.available_backends()``
   appears as a row of the backend table.
3. The update-capability table (rows ``| `name` | scoped | ... |``)
   covers every registered backend and agrees with
   ``repro_torch.api.update_capabilities()``.
4. The request-type table (rows ``| `MRRequest` | `mr` | ... |``)
   matches ``repro_torch.serve.reach_service.REQUEST_TYPES`` both ways.
5. The construction-mode table (rows ``| `serial` | `build_fast` | ...
   |``) matches ``repro_torch.core.hlindex.CONSTRUCTION_MODES`` both
   ways.
6. The on-disk format table (rows ``| `1` | `aligned-segments-v1` | ...
   |``) matches ``repro_torch.store.FORMAT_REGISTRY`` both ways.
7. The kernel table (rows ``| `label_join` | `label_join_ref` | CUDA
   cores | ... |``) matches ``repro_torch.kernels.KERNEL_REGISTRY`` both
   ways: name, plain version and the Hopper unit (``KernelSpec.unit``,
   which may be two words, as "tensor cores").
8. The "Multi-tenant serving" section's priority-class table against
   ``repro_torch.serve.scheduler.PRIORITY_CLASSES`` and its request-field
   table against ``dataclasses.fields(Request)``, both ways.
9. The "Workloads" section's capability table (header ``| backend |
   `witness` | ... |``) against ``repro_torch.api.workload_capabilities()``
   and ``WORKLOAD_OPS``, both ways, cell for cell.

and one of the port's own:

10. The "Launchers" section's dry-run cell table (rows ``|
    `maxmin__sp__allgather__float32` | ... |``) against
    ``repro_torch.launch.closure_dryrun.CELLS``, its model-family
    table (rows ``| `qwen3-1.7b` | `dense` | `TransformerLM` | ported
    |``, one per arch) against ``repro_torch.configs`` and
    ``repro_torch.models.registry.FAMILIES``, and its launcher table
    (rows ``| `launch/dryrun.py` | ported |``) against the modules of
    ``repro_torch.launch`` (each ``ported``) and the reference's launcher
    without one (``launch/hlo_analysis.py``: ``no counterpart``), all
    both ways; and the section names the reference modules that have no
    counterpart (``launch/hlo_analysis.py``, ``compat.py``).

  PYTHONPATH=src python -m repro_torch.tools.check_docs
"""
from __future__ import annotations

import dataclasses
import pathlib
import re
import sys
from typing import List

ROOT = pathlib.Path(__file__).resolve().parents[3]
ARCH = ROOT / "docs" / "ARCHITECTURE_TORCH.md"

_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_FENCE = re.compile(r"```.*?```", re.S)
_TABLE_ROW = re.compile(r"^\|\s*`([^`]+)`", re.M)
_CAPABILITY_ROW = re.compile(
    r"^\|\s*`([^`]+)`\s*\|\s*(scoped|incremental|rebuild|unsupported)\s*\|",
    re.M)
_REQUEST_ROW = re.compile(
    r"^\|\s*`(\w+Request)`\s*\|\s*`(\w+)`\s*\|", re.M)
_CONSTRUCTION_ROW = re.compile(
    r"^\|\s*`(\w+)`\s*\|\s*`(build_\w+)`\s*\|", re.M)
# a digit-only first cell is unique to the format-version table
_FORMAT_ROW = re.compile(r"^\|\s*`(\d+)`\s*\|\s*`([\w.-]+)`\s*\|", re.M)
# a `*_ref` second cell is unique to the kernel table; the unit cell is
# one or more words ("CUDA cores", "tensor cores")
_KERNEL_ROW = re.compile(
    r"^\|\s*`(\w+)`\s*\|\s*`(\w+_ref)`\s*\|\s*(\w+(?: \w+)*)\s*\|", re.M)
# scoped to the multi-tenant section: a bare-integer second cell is the
# priority-class table, a backticked third cell the field table
_PRIORITY_ROW = re.compile(r"^\|\s*`(\w+)`\s*\|\s*(\d+)\s*\|", re.M)
_FIELD_ROW = re.compile(
    r"^\|\s*`(\w+)`\s*\|\s*`[^`]+`\s*\|\s*`([^`]+)`\s*\|", re.M)


# scoped to the Launchers section
_CELL_ROW = re.compile(r"^\|\s*`(\w+__\w+__\w+__\w+)`\s*\|", re.M)
_FAMILY_ROW = re.compile(
    r"^\|\s*`([\w.-]+)`\s*\|\s*`(\w+)`\s*\|\s*`(\w+)`\s*\|"
    r"\s*(ported|not ported)\s*\|", re.M)
_LAUNCHER_ROW = re.compile(
    r"^\|\s*`(launch/\w+\.py)`\s*\|\s*(ported|no counterpart)\s*\|", re.M)
NO_COUNTERPART = ("launch/hlo_analysis.py", "compat.py")


def _section(text: str, title: str) -> str:
    """The body of one ``## title`` section (empty if absent)."""
    match = re.search(rf"^## {re.escape(title)}$(.*?)(?=^## |\Z)",
                      text, re.M | re.S)
    return match.group(1) if match else ""


def doc_files(root: pathlib.Path = ROOT):
    docs = root / "docs"
    return [root / "README.md"] + (sorted(docs.glob("*.md"))
                                   if docs.is_dir() else [])


def check_links(root: pathlib.Path = ROOT) -> List[str]:
    problems = []
    for md in doc_files(root):
        text = _FENCE.sub("", md.read_text())
        for match in _LINK.finditer(text):
            target = match.group(1)
            if target.startswith(("http://", "https://", "mailto:", "#")):
                continue
            path = target.split("#")[0]
            if path and not (md.parent / path).exists():
                problems.append(
                    f"{md.relative_to(root)}: broken link -> {target}")
    return problems


def check_backend_table(text: str) -> List[str]:
    from repro_torch.api import available_backends

    # catalogue rows only: a row of the update-capability table must not
    # satisfy this check
    documented = {name for line in text.splitlines()
                  if (match := _TABLE_ROW.match(line)) is not None
                  and not _CAPABILITY_ROW.match(line)
                  for name in [match.group(1)]}
    return [f"backend table is missing registered backend `{name}`"
            for name in available_backends() if name not in documented]


def check_update_capability_table(text: str) -> List[str]:
    from repro_torch.api import update_capabilities

    documented = dict(_CAPABILITY_ROW.findall(text))
    problems = []
    for name, cap in update_capabilities().items():
        if name not in documented:
            problems.append(f"update-capability table is missing registered "
                            f"backend `{name}` (declared: {cap})")
        elif documented[name] != cap:
            problems.append(f"declares `{name}` updates as "
                            f"'{documented[name]}' but the registry says "
                            f"'{cap}'")
    return problems


def _both_ways(what: str, live: dict, documented: dict,
               name_of=lambda value: value) -> List[str]:
    """``documented`` against ``live`` in both directions: every live key
    documented as ``name_of(value)``, every documented key live."""
    problems = []
    for key, value in live.items():
        want = name_of(value)
        if key not in documented:
            problems.append(f"{what} table is missing `{key}` (`{want}`)")
        elif documented[key] != want:
            problems.append(f"{what} table documents `{key}` as "
                            f"`{documented[key]}` but the code says "
                            f"`{want}`")
    for key in documented:
        if key not in live:
            problems.append(f"{what} table documents `{key}` "
                            f"(`{documented[key]}`) that the code does not "
                            f"have")
    return problems


def check_request_type_table(text: str) -> List[str]:
    from repro_torch.serve.reach_service import REQUEST_TYPES

    documented = {kind: cls_name
                  for cls_name, kind in _REQUEST_ROW.findall(text)}
    return _both_ways("request-type", REQUEST_TYPES, documented,
                      lambda cls: cls.__name__)


def check_construction_table(text: str) -> List[str]:
    from repro_torch.core.hlindex import CONSTRUCTION_MODES

    return _both_ways("construction-mode", CONSTRUCTION_MODES,
                      dict(_CONSTRUCTION_ROW.findall(text)),
                      lambda fn: fn.__name__)


def check_format_table(text: str) -> List[str]:
    from repro_torch.store import FORMAT_REGISTRY

    documented = {int(v): layout for v, layout in _FORMAT_ROW.findall(text)}
    return _both_ways("format-version", FORMAT_REGISTRY, documented)


def check_kernel_table(text: str) -> List[str]:
    from repro_torch.kernels import KERNEL_REGISTRY

    documented = {name: (oracle, unit)
                  for name, oracle, unit in _KERNEL_ROW.findall(text)}
    live = {name: (spec.reference.__name__, spec.unit)
            for name, spec in KERNEL_REGISTRY.items()}
    return _both_ways("kernel", live, documented)


def check_multitenant_section(text: str) -> List[str]:
    from repro_torch.serve.reach_service import Request
    from repro_torch.serve.scheduler import PRIORITY_CLASSES

    body = _section(text, "Multi-tenant serving")
    if not body:
        return ["no '## Multi-tenant serving' section"]
    classes = {name: int(band) for name, band in _PRIORITY_ROW.findall(body)}
    problems = _both_ways("priority-class", PRIORITY_CLASSES, classes)
    # defaults shown with double quotes in the docs; repr() uses single
    fields = {name: default.replace("'", '"')
              for name, default in _FIELD_ROW.findall(body)}
    live = {f.name: repr(f.default).replace("'", '"')
            for f in dataclasses.fields(Request)}
    return problems + _both_ways("request-field", live, fields)


def check_workload_table(text: str) -> List[str]:
    from repro_torch.api import WORKLOAD_OPS, workload_capabilities

    body = _section(text, "Workloads")
    if not body:
        return ["no '## Workloads' section"]
    header = re.search(r"^\|\s*backend\s*\|(.+)\|\s*$", body, re.M)
    if header is None:
        return ["Workloads section has no '| backend | ...' capability "
                "table header"]
    doc_ops = tuple(re.findall(r"`(\w+)`", header.group(1)))
    if doc_ops != tuple(WORKLOAD_OPS):
        return [f"workload-capability table header lists ops "
                f"{list(doc_ops)} but the live WORKLOAD_OPS is "
                f"{list(WORKLOAD_OPS)}"]
    documented = {}
    for line in body.splitlines():
        row = re.match(r"^\|\s*`([\w-]+)`\s*\|(.+)\|\s*$", line)
        if row is None:
            continue
        cells = [c.strip() for c in row.group(2).split("|")]
        if len(cells) == len(doc_ops) and set(cells) <= {"yes", "no"}:
            documented[row.group(1)] = {
                op: cell == "yes" for op, cell in zip(doc_ops, cells)}
    return _both_ways("workload-capability", workload_capabilities(),
                      documented)


def launcher_modules() -> dict:
    """``{"launch/<name>.py": "ported"}`` for every module of
    ``repro_torch.launch``, and ``"no counterpart"`` for the reference's
    launchers the port has none of."""
    import pkgutil

    import repro_torch.launch as launch
    live = {f"launch/{m.name}.py": "ported"
            for m in pkgutil.iter_modules(launch.__path__)}
    live.update({name: "no counterpart" for name in NO_COUNTERPART
                 if name.startswith("launch/")})
    return live


def check_launchers_section(text: str) -> List[str]:
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.closure_dryrun import CELLS, cell_tag
    from repro_torch.models.registry import FAMILIES

    body = _section(text, "Launchers")
    if not body:
        return ["no '## Launchers' section"]
    live_cells = {cell_tag(*cell): "cell" for cell in CELLS}
    problems = _both_ways("dry-run cell", live_cells,
                          {tag: "cell" for tag in _CELL_ROW.findall(body)})
    live = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        live[cfg.name] = (cfg.family, FAMILIES[cfg.family].__name__,
                          "ported")
    documented = {arch: (family, name, status) for arch, family, name, status
                  in _FAMILY_ROW.findall(body)}
    problems += _both_ways("model-family", live, documented)
    problems += _both_ways("launcher", launcher_modules(),
                           dict(_LAUNCHER_ROW.findall(body)))
    problems += [f"Launchers section does not name `{name}`, which has no "
                 f"counterpart" for name in NO_COUNTERPART
                 if f"`{name}`" not in body]
    return problems


def problems(arch: pathlib.Path = ARCH,
             root: pathlib.Path = ROOT) -> List[str]:
    """Every disagreement between ``arch`` (and the links of the docs
    under ``root``) and the port's code, each prefixed by the file."""
    out = check_links(root)
    if not arch.is_file():
        return out + [f"{arch.name} is missing"]
    text = arch.read_text()
    for check in (check_backend_table, check_update_capability_table,
                  check_request_type_table, check_construction_table,
                  check_format_table, check_kernel_table,
                  check_multitenant_section, check_workload_table,
                  check_launchers_section):
        out += [f"{arch.name}: {p}" for p in check(text)]
    return out


def main() -> int:
    found = problems()
    for p in found:
        print(f"FAIL: {p}")
    if found:
        return 1
    from repro_torch.api import available_backends
    from repro_torch.kernels import KERNEL_REGISTRY
    print(f"docs OK: links resolve in {len(doc_files())} files; "
          f"{ARCH.name} matches the port's backends "
          f"{available_backends()}, update and workload capabilities, "
          f"request types, construction modes, on-disk formats, kernels "
          f"{sorted(KERNEL_REGISTRY)}, priority classes, Request fields, "
          f"dry-run cells, model families and launchers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
