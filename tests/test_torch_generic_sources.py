"""The generic flash route's CUDA sources, read without a card.

K1g (``csrc/flash_attention_generic.cu``) and K2g/K3g
(``csrc/flash_attention_generic_bwd.cu``) take their staging, their
tensor-core products and their output copies from one header,
``csrc/flash_generic_sm90.cuh``: each building block is defined there once,
and a library's name hashes the header, so that an edit of it rebuilds
both sources. What the kernels compute is held against the plain versions
on the card in ``tests/test_torch_kernels_cuda.py``.
"""

import re
import shutil

import pytest

from distkeras_tpu_torch.utils import build

SOURCES = ["flash_attention_generic", "flash_attention_generic_bwd"]
HEADER = "flash_generic_sm90.cuh"
# Each shared building block and the text that defines it.
BLOCKS = {
    "stage16": r"void stage16\(",
    "stage32": r"void stage32\(",
    "Wgmma": r"struct Wgmma;",
    "Ops16": r"struct Ops16 \{",
    "split_tf32": r"void split_tf32\(",
    "mma_3xtf32": r"void mma_3xtf32\(",
    "OpsF32": r"struct OpsF32 \{",
    "causal_keys": r"int causal_keys\(",
    "tile_to_smem": r"void tile_to_smem\(",
    "smem_to_rows": r"void smem_to_rows\(",
    "granule": r"int granule\(",
    "launch_kernel": r"int launch_kernel\(",
}


def _read(name):
    return (build.CSRC_DIR / name).read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_generic_sources_include_the_shared_header(name):
    assert f'#include "{HEADER}"' in _read(f"{name}.cu")


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_building_block_is_defined_once_in_the_header(block):
    pattern = re.compile(BLOCKS[block])
    assert len(pattern.findall(_read(HEADER))) == 1
    for name in SOURCES:
        assert not pattern.search(_read(f"{name}.cu")), name


def test_forward_takes_its_products_from_the_shared_blocks():
    """K1g's products are the header's wgmma and 3xTF32 ones; the float32
    FMA loops of its first design are gone."""
    text = _read("flash_attention_generic.cu")
    assert "Ops::scores(" in text and "Ops::product(" in text
    for gone in ("load_tile", "tile_dots", "tile_product", "fmaf("):
        assert gone not in text, gone


def test_library_names_hash_the_shared_header(tmp_path, monkeypatch):
    """Editing the header renames (so rebuilds) both generic libraries;
    editing another source renames neither."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = {name: build._target(name) for name in SOURCES}
    (csrc / "fused_xent_fwd.cu").write_text(_read("fused_xent_fwd.cu") + "\n// edited\n")
    assert {name: build._target(name) for name in SOURCES} == before
    (csrc / HEADER).write_text(_read(HEADER) + "\n// edited\n")
    after = {name: build._target(name) for name in SOURCES}
    assert all(after[name] != before[name] for name in SOURCES)
