"""The port's kernel build cache: a library is named by a hash of its
source, of every header the source includes by quoted path, and of the
``nvcc`` flags, so editing a shared header rebuilds every kernel that uses
it.  Only the digest is tested: no ``nvcc`` is needed."""
import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture
def sources(tmp_path):
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "shared.cuh"\nint k;\n')
    (tmp_path / "shared.cuh").write_text(
        '#pragma once\n#include "inner.cuh"\nint s;\n')
    (tmp_path / "inner.cuh").write_text("int i;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    return tmp_path


def test_source_files_follow_quoted_includes(sources):
    names = sorted(p.name for p in _build.source_files(sources / "k.cu"))
    assert names == ["inner.cuh", "k.cu", "shared.cuh"]


def _digest(sources, flags=("-O3",)):
    """The hash that names the library built from ``k.cu``."""
    return _build.source_digest(sources / "k.cu", flags)


@pytest.mark.parametrize("edited", ["k.cu", "shared.cuh", "inner.cuh"])
def test_library_name_changes_with_an_included_file(sources, edited):
    before = _digest(sources)
    path = sources / edited
    path.write_text(path.read_text() + "// edited\n")
    assert _digest(sources) != before


def test_library_name_ignores_files_not_included(sources):
    before = _digest(sources)
    (sources / "other.cuh").write_text("int changed;\n")
    assert _digest(sources) == before


def test_library_name_changes_with_the_flags(sources):
    assert _digest(sources, ()) != _digest(sources, ("-fmad=false",))


@pytest.mark.parametrize("name", ["flash_attention", "decay_scan"])
def test_port_kernels_hash_their_headers(name):
    import importlib
    kernel = importlib.import_module(f"repro_torch.kernels.{name}").KERNEL
    files = {p.name for p in _build.source_files(kernel.source)}
    assert files == {f"{name}.cu", "hopper.cuh"}
    digest = _build.source_digest(kernel.source, kernel.flags)
    assert kernel.library_path().name == f"{name}-{digest[:16]}.so"
