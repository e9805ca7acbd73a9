"""The port stands alone: a fresh interpreter that imports
``repro_torch.api`` and every submodule has loaded neither ``jax`` nor the
reference package ``repro``, needs no CUDA compiler to import, and without
a CUDA device refuses to build unless the caller asks for the CPU.  (This
file imports both packages only to list the port's modules and to check
``chip_smoke.py``; the checks themselves run in subprocesses.)"""
import json
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import repro            # noqa: F401  (both packages importable side by side)
import repro_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _port_modules():
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def _run(code: str, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_module_list_is_what_the_slice_ships():
    assert _port_modules() == [
        "repro_torch", "repro_torch.api",
        "repro_torch.benchmarks",
        "repro_torch.benchmarks.attention_chunks",
        "repro_torch.benchmarks.bench_construction",
        "repro_torch.benchmarks.bench_maintenance",
        "repro_torch.benchmarks.bench_persistence",
        "repro_torch.benchmarks.bench_service_scale",
        "repro_torch.benchmarks.bench_serving",
        "repro_torch.benchmarks.bench_sharded",
        "repro_torch.benchmarks.bench_workloads",
        "repro_torch.benchmarks.common", "repro_torch.benchmarks.datasets",
        "repro_torch.benchmarks.kernels_bench",
        "repro_torch.benchmarks.paper_tables",
        "repro_torch.benchmarks.roofline", "repro_torch.benchmarks.run",
        "repro_torch.configs", "repro_torch.configs.arctic_480b",
        "repro_torch.configs.falcon_mamba_7b",
        "repro_torch.configs.llava_next_mistral_7b",
        "repro_torch.configs.minitron_8b", "repro_torch.configs.qwen2_5_14b",
        "repro_torch.configs.qwen2_7b", "repro_torch.configs.qwen2_moe_a2_7b",
        "repro_torch.configs.qwen3_1_7b",
        "repro_torch.configs.recurrentgemma_2b",
        "repro_torch.configs.whisper_large_v3",
        "repro_torch.convert",
        "repro_torch.core", "repro_torch.core.baselines",
        "repro_torch.core.distributed",
        "repro_torch.core.engine", "repro_torch.core.frontier",
        "repro_torch.core.hlindex",
        "repro_torch.core.hypergraph", "repro_torch.core.maintenance",
        "repro_torch.core.mesh",
        "repro_torch.core.minimal", "repro_torch.core.online",
        "repro_torch.core.query", "repro_torch.core.semiring",
        "repro_torch.device",
        "repro_torch.distributed_lm", "repro_torch.distributed_lm.compression",
        "repro_torch.distributed_lm.sharding",
        "repro_torch.examples", "repro_torch.examples.distributed_reachability",
        "repro_torch.examples.epidemic_case_study",
        "repro_torch.examples.quickstart",
        "repro_torch.examples.serve_lm",
        "repro_torch.examples.serving_quickstart",
        "repro_torch.examples.train_lm",
        "repro_torch.kernels",
        "repro_torch.kernels.build", "repro_torch.kernels.label_join",
        "repro_torch.kernels.maxmin_matmul", "repro_torch.kernels.ops",
        "repro_torch.kernels.overlap", "repro_torch.kernels.ref",
        "repro_torch.kernels.registry",
        "repro_torch.kernels.threshold_closure",
        "repro_torch.launch", "repro_torch.launch.closure_dryrun",
        "repro_torch.launch.dryrun",
        "repro_torch.launch.mesh", "repro_torch.launch.serve",
        "repro_torch.launch.shapes", "repro_torch.launch.train",
        "repro_torch.models", "repro_torch.models.common",
        "repro_torch.models.layers", "repro_torch.models.mamba",
        "repro_torch.models.registry", "repro_torch.models.rglru",
        "repro_torch.models.transformer", "repro_torch.models.whisper",
        "repro_torch.serve", "repro_torch.serve.kvcache",
        "repro_torch.serve.reach_service",
        "repro_torch.serve.replicas", "repro_torch.serve.scheduler",
        "repro_torch.serve.serve_step",
        "repro_torch.store", "repro_torch.store.format",
        "repro_torch.store.hif", "repro_torch.store.store",
        "repro_torch.store.wal",
        "repro_torch.tools", "repro_torch.tools.check_docs",
        "repro_torch.train", "repro_torch.train.checkpoint",
        "repro_torch.train.data", "repro_torch.train.fault_tolerance",
        "repro_torch.train.optimizer", "repro_torch.train.train_step",
        "repro_torch.workloads", "repro_torch.workloads.base",
        "repro_torch.workloads.hop_bounded", "repro_torch.workloads.oracle",
        "repro_torch.workloads.setops", "repro_torch.workloads.topk",
        "repro_torch.workloads.witness",
    ]


@pytest.fixture(scope="module")
def import_report():
    """One fresh interpreter imports ``repro_torch.api`` and then every
    submodule, and reports after each what it has loaded of jax or the
    reference."""
    out = _run(
        "import importlib, json, sys\n"
        "import repro_torch.api\n"
        "report = {}\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "    report[name] = sorted(\n"
        "        m for m in sys.modules if m.split('.')[0] in\n"
        "        ('jax', 'jaxlib', 'repro'))\n"
        "assert 'torch' in sys.modules and 'numpy' in sys.modules\n"
        "print(json.dumps(report))\n")
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("module", _port_modules())
def test_import_drags_in_neither_jax_nor_the_reference(import_report, module):
    assert import_report[module] == []


@pytest.mark.parametrize("module", ["repro_torch.core.online",
                                    "repro_torch.core.frontier",
                                    "repro_torch.core.baselines",
                                    "repro_torch.core.mesh",
                                    "repro_torch.core.distributed",
                                    "repro_torch.workloads",
                                    "repro_torch.workloads.base",
                                    "repro_torch.workloads.hop_bounded",
                                    "repro_torch.workloads.oracle",
                                    "repro_torch.workloads.setops",
                                    "repro_torch.workloads.topk",
                                    "repro_torch.workloads.witness",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.benchmarks.roofline"])
def test_backend_module_alone_loads_neither_jax_nor_the_reference(module):
    """The index-free, baseline, mesh and workload modules and the LM
    dry-run and roofline, each imported first and alone in a fresh
    interpreter (the reference keeps
    numpy-only copies of some of them in a package whose ``__init__``
    imports JAX, and builds its mesh from ``jax.sharding``)."""
    out = _run(
        "import importlib, json, sys\n"
        f"mod = importlib.import_module({module!r})\n"
        "print(json.dumps([sorted(mod.__all__), sorted(\n"
        "    m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'repro'))]))\n")
    assert out.returncode == 0, out.stderr
    names, loaded = json.loads(out.stdout)
    assert loaded == []
    assert names


@pytest.mark.parametrize("package", ["repro_torch.benchmarks",
                                     "repro_torch.examples",
                                     "repro_torch.tools",
                                     "repro_torch.launch",
                                     "repro_torch.models",
                                     "repro_torch.configs",
                                     "repro_torch.train",
                                     "repro_torch.distributed_lm"])
def test_suite_package_alone_loads_neither_jax_nor_the_reference(package):
    """The benchmark suite, the examples, the docs check, the launchers,
    the models and their configs, the training stack and the LM
    distribution glue, each package imported first and alone in a fresh
    interpreter, then every module of it (the reference's copies of them
    import ``repro`` and JAX; its ``train.data`` reaches ``repro.core``)."""
    mods = [m for m in _port_modules() if m.startswith(package + ".")]
    assert mods
    out = _run(
        "import importlib, json, sys\n"
        f"loaded = []\n"
        f"for name in {[package] + mods!r}:\n"
        "    importlib.import_module(name)\n"
        "    loaded.append(sorted(m for m in sys.modules if m.split('.')[0]\n"
        "                         in ('jax', 'jaxlib', 'repro')))\n"
        "print(json.dumps(loaded))\n")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [[]] * (len(mods) + 1)


def test_sources_name_neither_jax_nor_the_reference_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import repro\b|from repro\b|from repro\.)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for no, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.match(line), f"{path}:{no}: {line}"


def test_serve_package_keeps_the_lm_stack_out_until_asked():
    """``repro_torch.serve`` resolves its exports lazily, as the
    reference's: the reachability service alone loads no model module,
    and the LM drivers load the model stack on first use."""
    out = _run(
        "import json, sys\n"
        "from repro_torch.serve import ReachabilityService\n"
        "before = sorted(m for m in sys.modules if m.startswith(\n"
        "    ('repro_torch.models', 'repro_torch.serve.kvcache')))\n"
        "from repro_torch.serve import prefill_with_decode, make_serve_step\n"
        "after = 'repro_torch.serve.kvcache' in sys.modules\n"
        "print(json.dumps([before, after]))\n")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == [[], True]


def test_build_engine_without_cuda_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    out = _run(
        "from repro_torch.api import build_engine, random_hypergraph\n"
        "h = random_hypergraph(30, 40, seed=1)\n"
        "try:\n"
        "    build_engine(h)\n"
        "except RuntimeError as e:\n"
        "    assert \"device='cpu'\" in str(e), e\n"
        "else:\n"
        "    raise SystemExit('build_engine(h) carried on without a GPU')\n"
        "eng = build_engine(h, device='cpu', use_kernels=True)\n"
        "print(eng.name, eng.mr_batch([0, 1], [2, 3]).dtype)\n")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["hl-index", "int32"]


def test_device_probe_and_resolve_device():
    from repro_torch.device import gpu_probe, resolve_device
    probe = gpu_probe()
    assert set(probe) == {"cuda", "device_name", "nvcc"}
    assert probe["cuda"] == torch.cuda.is_available()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if not probe["cuda"]:
        for device in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(device)


def test_kernel_build_fails_loudly_without_a_compiler(tmp_path):
    from repro_torch.device import find_nvcc
    from repro_torch.kernels import build
    with pytest.raises(FileNotFoundError):
        build.build_libraries(["no_such_kernel"], tmp_path)
    if find_nvcc() is not None:
        pytest.skip("nvcc is present here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_libraries(["label_join", "maxmin_matmul", "overlap",
                               "threshold_step"], tmp_path)
    assert not any(tmp_path.iterdir())


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
