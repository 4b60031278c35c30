"""The port's boundaries: no JAX, no keto_tpu, none of the reference's
serving libraries (httpx, aiohttp; grpc and protobuf only in the gRPC
plane, which only the registry imports, lazily), no quiet CPU fallback."""

import ast
import re
from pathlib import Path

import pytest
import torch
import torch.utils.cpp_extension

from keto_tpu_torch.engine import ClosureCheckEngine, DeviceCheckEngine
from keto_tpu_torch.engine import masked_spmv
from keto_tpu_torch.graph import SnapshotManager
from keto_tpu_torch.ops import packed
from keto_tpu_torch.store import InMemoryTupleStore
from keto_tpu_torch.utils import kernels

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "keto_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]
# the gRPC plane: the only port modules that may import grpc and protobuf
API = REPO / "keto_tpu_torch" / "api"
GEN_FILES = sorted((API / "gen").rglob("*.py"))
GRPC_PLANE = {
    API / name
    for name in ("services.py", "interceptors.py", "reflection.py", "convert.py",
                 "grpc_servers.py")
} | set(GEN_FILES) | {
    REPO / "keto_tpu_torch" / "client" / "grpc_client.py",
    REPO / "keto_tpu_torch" / "cli" / "remote.py",
}


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_jax_and_no_keto_tpu_imports(path):
    assert path.exists()
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "keto_tpu"), f"{path}: {mod}"


def module_level_imports(path):
    """Roots of the modules a file imports outside any function or class."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            for child in ast.walk(node):
                child._nested = True
    for node in ast.walk(tree):
        if getattr(node, "_nested", False):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_serving_library_imports(path):
    """The port's server, CLI and smoke run on the standard library, so
    they run where the reference's serving libraries are missing. grpc and
    protobuf are admitted in the gRPC plane's modules only. PyYAML is
    optional, imported only inside the YAML loader."""
    forbidden = {"aiohttp", "click", "jsonschema", "httpx"}
    if path not in GRPC_PLANE:
        forbidden |= {"grpc", "google"}
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in forbidden, f"{path}: {mod}"
    assert "yaml" not in set(module_level_imports(path)), path


def module_level_relative_targets(path):
    """The port modules a file imports relatively outside any function or
    class, as paths (a package, or a module of it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            for child in ast.walk(node):
                child._nested = True
    for node in ast.walk(tree):
        if getattr(node, "_nested", False) or not isinstance(node, ast.ImportFrom):
            continue
        if node.level == 0:
            continue
        base = path.parent
        for _ in range(node.level - 1):
            base = base.parent
        for part in (node.module or "").split("."):
            if part:
                base = base / part
        yield base
        for alias in node.names:
            yield base / alias.name


def _in_grpc_plane(target: Path) -> bool:
    return (
        target.with_suffix(".py") in GRPC_PLANE
        or target == API / "gen"
        or API / "gen" in target.parents
    )


@pytest.mark.parametrize(
    "path", [p for p in PORT_FILES if p not in GRPC_PLANE], ids=lambda p: p.name
)
def test_only_the_grpc_plane_imports_it_at_module_level(path):
    """Outside the gRPC plane no module imports the plane when it is
    imported: the registry reaches it inside the function that builds it,
    so the package imports where grpc and protobuf do not."""
    hits = [t for t in module_level_relative_targets(path) if _in_grpc_plane(t)]
    assert not hits, f"{path}: {hits}"


@pytest.mark.parametrize("path", GEN_FILES, ids=lambda p: str(p.relative_to(API)))
def test_generated_modules_import_relatively_and_leave_sys_path(path):
    """An absolute ``ory`` import would resolve to keto_tpu's copy in a
    process that loaded it; ``sys.path`` stays untouched."""
    for mod in imported_modules(path):
        assert mod.split(".")[0] not in ("sys", "ory", "health", "reflection"), (
            f"{path}: {mod}"
        )


# the port's rule as a text search over every line, so an import the AST
# walk above cannot see (inside a string handed to exec) is caught too; the
# port imports its own package relatively, and the smoke through port()
_FORBIDDEN_IMPORT = re.compile(
    r"import (jax|keto_tpu|httpx|aiohttp)|from (jax|keto_tpu|httpx|aiohttp)"
)
# grpc and protobuf, outside the gRPC plane (``grpc_servers`` is a module
# of the plane, which the registry may name)
_FORBIDDEN_GRPC = re.compile(r"(import|from) (grpc|google)\b")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_forbidden_import_text(path):
    lines = path.read_text().splitlines()
    hits = [line for line in lines if _FORBIDDEN_IMPORT.search(line)]
    if path not in GRPC_PLANE:
        hits += [line for line in lines if _FORBIDDEN_GRPC.search(line)]
    assert not hits, f"{path}: {hits}"


def test_registry_without_device_raises_when_cuda_is_missing(monkeypatch):
    from keto_tpu_torch.driver import Config, Registry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Registry(Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        Registry(Config(), device="cuda")
    Registry(Config(), device="cpu")  # asked for explicitly: fine


def test_engine_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgr = SnapshotManager(InMemoryTupleStore())
    with pytest.raises(RuntimeError, match="CUDA"):
        ClosureCheckEngine(mgr)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClosureCheckEngine(mgr, device="cuda")
    ClosureCheckEngine(mgr, device="cpu")  # asked for explicitly: fine


def test_device_engine_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mgr = SnapshotManager(InMemoryTupleStore())
    for mode in ("packed", "dense", "scatter", "auto"):
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceCheckEngine(mgr, mode=mode)
    DeviceCheckEngine(mgr, mode="packed", device="cpu")


def test_wrapper_never_runs_the_plain_version_off_the_cpu():
    f = torch.zeros((128, 256), dtype=torch.bfloat16, device="meta")
    a = torch.zeros((256, 256), dtype=torch.bfloat16, device="meta")
    before = masked_spmv.masked_step.launches
    with pytest.raises(ValueError):
        masked_spmv.masked_step(f, a, f)
    assert masked_spmv.masked_step.launches == before


def test_packed_wrapper_never_runs_the_plain_version_off_the_cpu():
    f = torch.zeros((256, 128), dtype=torch.int32, device="meta")
    e = torch.zeros(1024, dtype=torch.int32, device="meta")
    before = packed.packed_propagate.launches
    with pytest.raises(ValueError):
        packed.packed_propagate(f, e, e, 256 + 4096)
    assert packed.packed_propagate.launches == before


def test_kernel_load_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)  # nothing built yet
    monkeypatch.setattr(kernels, "_libs", {})
    monkeypatch.setattr(torch.utils.cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.load("masked_spmv")


def test_library_name_follows_the_headers(monkeypatch, tmp_path):
    for src in kernels.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = kernels._lib_path("masked_spmv")
    assert kernels._lib_path("masked_spmv") == before  # stable
    header = tmp_path / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n// touched\n")
    assert kernels._lib_path("masked_spmv") != before
    (tmp_path / "extra.cuh").write_text("#pragma once\n")  # a new header too
    assert kernels._lib_path("masked_spmv") != before


def test_every_kernel_source_is_known():
    assert kernels.kernel_names() == ["masked_spmv", "packed_propagate"]
