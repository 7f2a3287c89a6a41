"""The port's notebooks (``examples/torch/notebooks``): valid nbformat-4
JSON whose code cells compile, as ``tests/test_notebooks.py`` holds the
reference's, mirroring the reference's two notebooks cell for cell on the
port (the same number of code cells), importing nothing of JAX or the
reference, and defaulting to the card."""

import json
import pathlib

import pytest

ROOT = pathlib.Path(__file__).parent.parent
NOTEBOOKS = sorted((ROOT / "examples" / "torch" / "notebooks").glob("*.ipynb"))


def test_notebooks_exist():
    assert {p.name for p in NOTEBOOKS} == {"mnist.ipynb", "workflow.ipynb"}


def _code(path):
    nb = json.loads(path.read_text())
    assert nb["nbformat"] == 4
    return ["".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "code"]


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_wellformed_and_compiles(path):
    cells = _code(path)
    assert cells
    for i, src in enumerate(cells):
        compile(src, f"{path.name}:cell{i}", "exec")


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_mirrors_the_reference_on_the_port(path):
    cells = _code(path)
    want = _code(ROOT / "examples" / "notebooks" / path.name)
    # the reference's first cell pins JAX's platform; the port's names the device
    assert len(cells) == len(want)
    text = "\n".join(cells)
    assert "import distkeras_tpu_torch as dk" in text and "DEVICE = 'cuda'" in text
    for line in text.splitlines():
        words = line.split()
        if len(words) >= 2 and words[0] in ("import", "from"):
            assert words[1].split(".")[0] not in ("distkeras_tpu", "jax", "sklearn"), line
