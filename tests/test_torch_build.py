"""The port's kernel build names its library by a hash of what it
compiles: every ``csrc/*.cu`` and every header beside them (``*.cuh``), so
an edit to a header never loads a stale library.  Checked on a copy of
the sources; no ``nvcc`` is needed."""

import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(build.CSRC, dst)
    return dst


def test_sources_are_the_translation_units(csrc):
    """Only the ``.cu`` files compile; the shared header is among the
    files, not among the units."""
    names = [p.name for p in build._sources(csrc)]
    assert names == sorted(names) and names
    assert all(n.endswith(".cu") for n in names)
    assert "flash_attention_bwd.cu" in names
    assert (csrc / "hopper.cuh").exists()
    assert build._digest(csrc) == build._digest(build.CSRC)


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attention_bwd.cu"])
def test_digest_changes_with_any_source_byte(csrc, name):
    before = build._digest(csrc)
    path = csrc / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    after = build._digest(csrc)
    assert after != before
    path.write_bytes(path.read_bytes()[:-len(b"\n// edited\n")])
    assert build._digest(csrc) == before


def test_digest_sees_a_new_header(csrc):
    before = build._digest(csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._digest(csrc) != before
    assert "extra.cuh" not in [p.name for p in build._sources(csrc)]
