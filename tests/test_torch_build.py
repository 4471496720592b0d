"""PyTorch port, the kernel build's key: it covers every `.cu` and `.cuh`
file under `csrc/`, so a change to any header (or a new one) rebuilds the
library instead of loading a stale one.  Runs on a copy of the sources."""

import shutil

import pytest

from indextts_tpu_torch.ops.cuda import _build


@pytest.fixture()
def csrc(tmp_path):
    root = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, root)
    return root


def test_key_covers_the_shipped_sources():
    names = {p.name for p in _build.CSRC.iterdir() if p.suffix in (".cu", ".cuh")}
    assert {"trunk_common.cuh", "trunk_products.cuh", "decode_layer.cu",
            "pool_trunk.cu"} <= names
    assert {p.name for p in _build.sources()} == {n for n in names if n.endswith(".cu")}


@pytest.mark.parametrize("name", sorted(p.name for p in _build.CSRC.iterdir()
                                        if p.suffix in (".cu", ".cuh")))
def test_key_changes_when_any_source_changes(csrc, name):
    before = _build.digest(csrc)
    assert _build.digest(csrc) == before                    # stable
    path = csrc / name
    path.write_bytes(path.read_bytes() + b"\n// edited\n")
    assert _build.digest(csrc) != before


def test_key_changes_when_a_header_is_added(csrc):
    before = _build.digest(csrc)
    (csrc / "new_helpers.cuh").write_text("#pragma once\n")
    assert _build.digest(csrc) != before
